"""Generation: prefill, then one decode forward per new token.

The decode loop is a Python loop of eager forwards; a step issues its work
to the device and does not wait for it (greedy sampling is an on-device
argmax, EOS masking an on-device select), so the host runs ahead of the
card until the final `torch.stack`.
"""

from __future__ import annotations

import torch

from flash_attention_cute_tpu_torch.models.cache import KVCache, QuantizedKVCache
from flash_attention_cute_tpu_torch.models.config import ModelConfig
from flash_attention_cute_tpu_torch.models.transformer import forward
from flash_attention_cute_tpu_torch.runtime.sampling import SamplingParams, sample_token


def prefill(
    params: dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,
    cache_capacity: int,
    cache_dtype=None,
) -> tuple[torch.Tensor, KVCache | QuantizedKVCache]:
    """Run the prompt [B, S] through the model on its device.

    `cache_dtype=torch.int8` (or `torch.float8_e4m3fn`) selects the
    quantized KV cache: K/V quantize per token as they are written, and
    decode attention folds the scales in (kernel B7).

    Returns (last-position logits [B, V] fp32, filled cache)."""
    b, s = input_ids.shape
    if cache_capacity < s:
        raise ValueError(f"cache_capacity {cache_capacity} < prompt length {s}")
    if cache_dtype is not None and cache_dtype.itemsize == 1:
        cache = QuantizedKVCache.create(cfg, batch=b, capacity=cache_capacity,
                                        dtype=cache_dtype, device=input_ids.device)
    else:
        cache = KVCache.create(cfg, batch=b, capacity=cache_capacity, dtype=cache_dtype,
                               device=input_ids.device)
    logits, cache = forward(params, cfg, input_ids, cache=cache, mode="prefill")
    return logits[:, -1], cache


def decode_loop(
    params: dict,
    cfg: ModelConfig,
    first_token: torch.Tensor,
    cache: KVCache,
    max_new_tokens: int,
    sampling: SamplingParams = SamplingParams(),
    eos_token_id: int | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Autoregressive decode from `first_token` [B]. Returns [B, max_new_tokens].

    Rows that emitted EOS keep emitting EOS (done-masking). The cache's
    buffers are updated in place. Caller contract: the cache holds
    lengths + max_new_tokens positions."""
    tok = first_token
    if eos_token_id is not None:
        done = first_token == eos_token_id  # the first token may already be EOS
    out = []
    for _ in range(max_new_tokens):
        logits, cache = forward(params, cfg, tok[:, None], cache=cache, mode="decode")
        nxt = sample_token(logits[:, 0], generator, sampling)
        if eos_token_id is not None:
            nxt = torch.where(done, eos_token_id, nxt)
            done = done | (nxt == eos_token_id)
        out.append(nxt)
        tok = nxt
    if not out:
        return first_token.new_empty((first_token.shape[0], 0))
    return torch.stack(out, dim=1)


def generate(
    params: dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,
    max_new_tokens: int,
    cache_capacity: int | None = None,
    cache_dtype=None,
    sampling: SamplingParams = SamplingParams(),
    eos_token_id: int | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Prefill + decode on the device of `input_ids`. Returns the generated
    ids [B, max_new_tokens] int32."""
    b, s = input_ids.shape
    if cache_capacity is None:
        cache_capacity = s + max_new_tokens
    last_logits, cache = prefill(params, cfg, input_ids, cache_capacity, cache_dtype)
    first = sample_token(last_logits, generator, sampling)
    if max_new_tokens == 1:
        return first[:, None]
    rest = decode_loop(params, cfg, first, cache, max_new_tokens - 1,
                       sampling=sampling, eos_token_id=eos_token_id, generator=generator)
    return torch.cat([first[:, None], rest], dim=1)


def greedy_generate(params, cfg, input_ids, max_new_tokens, **kw) -> torch.Tensor:
    """Greedy decoding."""
    return generate(params, cfg, input_ids, max_new_tokens,
                    sampling=SamplingParams(temperature=0.0), **kw)
