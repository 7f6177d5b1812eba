"""The Llama transformer: prefill and decode forwards over a stacked cache.

Parameters are a dict of tensors in the JAX package's layout: `embed`
[V, E], `final_ln` [E], optional `lm_head` [E, V] (absent: tied to the
embeddings), and `layers`, a dict of stacked [L, ...] weights named
`input_ln`, `post_ln`, `q_proj` ... `down_proj`, each projection [in, out].

  * mode="prefill": causal attention over the fresh K/V (kernel P on CUDA);
    with a cache, K/V are then written at positions [0, S) in place.
  * mode="decode": one token per row; K/V are written in place at each
    row's length, then split-KV decode attention (kernels D1 + D2) reads
    layer `l` of the stacked cache through a view.

Layers run as a Python loop; nothing in a step waits on the device.
"""

from __future__ import annotations

import torch

from flash_attention_cute_tpu_torch.api import flash_attention_forward
from flash_attention_cute_tpu_torch.models import layers as L
from flash_attention_cute_tpu_torch.models.cache import KVCache
from flash_attention_cute_tpu_torch.models.config import ModelConfig
from flash_attention_cute_tpu_torch.ops.flash_decode import (
    flash_attention_decode,
    flash_attention_decode_plain,
)
from flash_attention_cute_tpu_torch.ops.flash_fwd import flash_attention_fwd_plain


def check_supported(cfg: ModelConfig) -> None:
    """Raise on configuration bits of families this slice does not run."""
    later = [
        name for name, on in (
            ("attention_bias", cfg.attention_bias),
            ("sliding window", cfg.use_sliding_window or cfg.layer_window_pattern is not None),
            ("logit_softcap", cfg.logit_softcap is not None),
            ("final_logit_softcap", cfg.final_logit_softcap is not None),
            ("sandwich_norms", cfg.sandwich_norms),
            ("scale_embeddings", cfg.scale_embeddings),
            ("hidden_activation", cfg.hidden_activation != "silu"),
        ) if on
    ]
    if later:
        raise NotImplementedError(
            f"{', '.join(later)}: Qwen2 / Gemma2 / Mistral features are ROADMAP.md A10"
        )


def forward(
    params: dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,
    cache: KVCache | None = None,
    mode: str = "prefill",
    plain_attention: bool = False,
) -> tuple[torch.Tensor, KVCache | None]:
    """Causal-LM forward.

    Args:
      input_ids: [B, S] integer ids on the parameters' device.
      cache: required for mode="decode"; its buffers are updated in place
        and the returned cache shares them (with lengths + S). Caller
        contract: lengths + S <= capacity.
      mode: "prefill" | "decode" ("extend" is ROADMAP.md A6).
      plain_attention: run attention through the kernels' plain PyTorch
        versions whatever the device (the comparison path).

    Returns (logits [B, S, vocab] fp32, updated cache or None).
    """
    if mode == "extend":
        raise NotImplementedError("mode='extend' (chunked prefill) is ROADMAP.md A6")
    if mode not in ("prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    check_supported(cfg)
    b, s = input_ids.shape
    if mode == "decode":
        if cache is None or s != 1:
            raise ValueError("mode='decode' needs a cache and seqlen 1")

    x = params["embed"][input_ids].to(cfg.dtype)
    dev = x.device
    steps = torch.arange(s, device=dev)
    positions = steps.expand(b, s) if mode == "prefill" else cache.lengths[:, None] + steps
    cos, sin = L.rope_cos_sin(positions, L.rope_inv_freq(cfg, dev), cfg.dtype)
    scale = cfg.attention_scale

    if mode == "decode":
        new_len = cache.lengths + s
        # Index grids of the in-place append at each row's length.
        rows = torch.arange(b, device=dev)[:, None, None]
        heads = torch.arange(cfg.num_kv_heads, device=dev)[None, :, None]
        slots = positions[:, None, :]

    for li in range(cfg.num_layers):
        lp = {name: w[li] for name, w in params["layers"].items()}
        h = L.rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
        q, k, v = L.qkv_project(h, lp, cfg)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
        if mode == "prefill":
            if plain_attention:
                attn = flash_attention_fwd_plain(q, k, v, scale, causal=True)
            else:
                attn = flash_attention_forward(q, k, v, softmax_scale=scale, causal=True)
            if cache is not None:
                cache.k[li, :, :, :s] = k
                cache.v[li, :, :, :s] = v
        else:
            cache.k[li][rows, heads, slots] = k.to(cache.k.dtype)
            cache.v[li][rows, heads, slots] = v.to(cache.v.dtype)
            decode = flash_attention_decode_plain if plain_attention else flash_attention_decode
            attn = decode(q, cache.k, cache.v, kv_length=new_len, sm_scale=scale, layer=li)
        x = L.layer_tail(x, attn, lp, cfg)

    x = L.rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
    lm_head = params.get("lm_head")
    if lm_head is None:  # tied embeddings
        lm_head = params["embed"].T
    logits = (x @ lm_head.to(x.dtype)).float()
    if cache is None:
        return logits, None
    return logits, KVCache(k=cache.k, v=cache.v, lengths=cache.lengths + s)


def init_params(
    cfg: ModelConfig,
    seed: int = 0,
    generator: torch.Generator | None = None,
    device="cuda",
) -> dict:
    """Random parameters for tests and benchmarks, drawn on `device` from
    `generator` (or a new one seeded with `seed`). Projections are normal
    with std fan_in ** -0.5, embeddings with std 0.02, norms are ones. Each
    stacked weight is drawn one layer at a time in fp32 and cast, so the
    fp32 staging stays one layer's size."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    dt = cfg.dtype
    e, f = cfg.hidden_size, cfg.intermediate_size
    hq = cfg.num_q_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    nl = cfg.num_layers

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
                .mul_(std).to(dt))

    def stacked(fan_in, fan_out):
        out = torch.empty((nl, fan_in, fan_out), dtype=dt, device=device)
        for li in range(nl):
            out[li] = normal((fan_in, fan_out), fan_in ** -0.5)
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    params = {
        "embed": normal((cfg.vocab_size, e), 0.02),
        "layers": {
            "input_ln": ones(nl, e),
            "post_ln": ones(nl, e),
            "q_proj": stacked(e, hq),
            "k_proj": stacked(e, hkv),
            "v_proj": stacked(e, hkv),
            "o_proj": stacked(hq, e),
            "gate_proj": stacked(e, f),
            "up_proj": stacked(e, f),
            "down_proj": stacked(f, e),
        },
        "final_ln": ones(e),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal((e, cfg.vocab_size), e ** -0.5)
    return params
