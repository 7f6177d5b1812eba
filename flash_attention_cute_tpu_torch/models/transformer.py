"""The Llama-family transformer (Llama, Qwen2, Mistral, Gemma2): prefill,
extend and decode forwards over a stacked cache.

Parameters are a dict of tensors in the JAX package's layout: `embed`
[V, E], `final_ln` [E], optional `lm_head` [E, V] (absent: tied to the
embeddings), and `layers`, a dict of stacked [L, ...] weights named
`input_ln`, `post_ln`, `q_proj` ... `down_proj`, each projection [in, out].
A fused tree (models/fuse.py) holds `qkv_proj` and `gate_up_proj` in place
of q/k/v and gate/up. Any projection and the lm_head may be an int8 or
int4 quantized weight (models/quantize.py): `models.layers.dense` runs it
through kernel B10 or B11 on CUDA, one layer (`w[li]`) at a time. Qwen2
trees add `q_bias` / `k_bias` / `v_bias` (or a fused `qkv_bias`), kept in
the model dtype. Gemma2 trees add `pre_ffw_ln` / `post_ffw_ln` (sandwich
norms, `models.layers.layer_tail`), their norm weights already holding
Gemma's +1 (the JAX package folds it in at conversion).

Sliding windows follow `ModelConfig.layer_window` (the JAX package's
segment rule, or Gemma2's periodic pattern): each layer's attention, in
every mode, takes its window, so a windowed prefill runs kernel B2 where
the window binds (P otherwise) and decode and extend read only the keys
inside it. Every attention call takes `cfg.logit_softcap` (Gemma2's tanh
soft cap): P, B2, D1, B4, B5-B9 and B12 take it and head dim 256 in kernel
form; only the backward (B13a / B13b) takes neither.

  * mode="prefill": causal attention over the fresh K/V (kernel P on CUDA);
    with a cache, K/V are then written at positions [0, S) in place.
  * mode="extend": S new tokens per row at positions lengths + s; their
    K/V are written in place, then the chunk attends layer `l` of the cache
    with q_offset = lengths, kv_length = lengths + S (top-left causality in
    global positions: kernel B4 on CUDA, or D1 + D2 when S == 1). This is
    the verify step of speculative decoding and a chunk of chunked prefill.
  * mode="decode": one token per row; K/V are written in place at each
    row's length, then split-KV decode attention (kernels D1 + D2) reads
    layer `l` of the stacked cache through a view.

With a `QuantizedKVCache` the writes quantize each row per token (kernel
QA on CUDA) and decode attention is kernel B7 (+ D2) over the int8 / e4m3
values and their scales; prefill still attends the fresh, unquantized K/V,
and extend dequantizes the layer's slab and takes the dense extend route
(B4), as the JAX package does.

Layers run as a Python loop; nothing in a step waits on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flash_attention_cute_tpu_torch.api import flash_attention_forward
from flash_attention_cute_tpu_torch.models import layers as L
from flash_attention_cute_tpu_torch.models.cache import KVCache, QuantizedKVCache
from flash_attention_cute_tpu_torch.models.config import ModelConfig
from flash_attention_cute_tpu_torch.ops.flash_chunked import flash_attention_chunked_plain
from flash_attention_cute_tpu_torch.ops.flash_decode import (
    flash_attention_decode,
    flash_attention_decode_plain,
)
from flash_attention_cute_tpu_torch.ops.flash_fwd import flash_attention_fwd_plain
from flash_attention_cute_tpu_torch.ops.quantized import (
    dequantize_kv,
    flash_attention_decode_quantized,
    flash_attention_decode_quantized_plain,
    quantize_append,
)
from flash_attention_cute_tpu_torch.ops.quantized_matmul import QUANTIZED


BIAS_STD = 0.5  # init_params' q/k/v biases: against projections of std about 1


def forward(
    params: dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,
    cache: KVCache | QuantizedKVCache | None = None,
    mode: str = "prefill",
    plain_attention: bool = False,
    return_hidden: bool = False,
) -> tuple[torch.Tensor, KVCache | QuantizedKVCache | None]:
    """Causal-LM forward.

    Args:
      input_ids: [B, S] integer ids on the parameters' device.
      cache: required for mode="extend" and "decode"; its buffers are
        updated in place and the returned cache shares them (with lengths +
        S). Caller contract: lengths + S <= capacity (an index past the
        capacity raises on the CPU and faults on the card; the JAX
        package's clamped write has no counterpart). A `QuantizedKVCache`
        selects the quantized writes and attention.
      mode: "prefill" (from position 0) | "extend" (S tokens at each row's
        length) | "decode" (one token at each row's length).
      plain_attention: run attention through the kernels' plain PyTorch
        versions whatever the device (the comparison path).
      return_hidden: return the final-norm hidden states [B, S, E] in the
        model dtype in place of the logits (the task heads' trunk,
        models/heads.py).

    Returns (logits [B, S, vocab] fp32, updated cache or None).
    """
    if mode not in ("prefill", "extend", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    b, s = input_ids.shape
    if mode != "prefill" and cache is None:
        raise ValueError(f"mode={mode!r} needs a cache")
    if mode == "decode" and s != 1:
        raise ValueError("mode='decode' needs seqlen 1")

    x = L.embed(params, input_ids, cfg)
    dev = x.device
    steps = torch.arange(s, device=dev)
    positions = steps.expand(b, s) if mode == "prefill" else cache.lengths[:, None] + steps
    cos, sin = L.rope_cos_sin(positions, L.rope_inv_freq(cfg, dev), cfg.dtype)
    scale, softcap = cfg.attention_scale, cfg.logit_softcap

    quant = isinstance(cache, QuantizedKVCache)
    if quant:
        # Where each row's new tokens go: prefill writes from position 0.
        write_at = torch.zeros_like(cache.lengths) if mode == "prefill" else cache.lengths
    if mode != "prefill":
        new_len = cache.lengths + s
    if mode != "prefill" and not quant:
        # Index grids of the in-place append at each row's length.
        rows = torch.arange(b, device=dev)[:, None, None]
        heads = torch.arange(cfg.num_kv_heads, device=dev)[None, :, None]
        slots = positions[:, None, :]

    # One unbind per plain stacked weight: its backward stacks the layers'
    # gradients once, where `w[li]` would write a zero [L, ...] gradient per
    # layer. Quantized leaves (not trained) take one layer as a view.
    stacked = {name: w if isinstance(w, QUANTIZED) else w.unbind(0)
               for name, w in params["layers"].items()}
    for li in range(cfg.num_layers):
        lp = {name: w[li] for name, w in stacked.items()}
        window = cfg.layer_window(li)
        h = L.rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
        q, k, v = L.qkv_project(h, lp, cfg)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
        if mode == "prefill":
            if plain_attention:
                attn = flash_attention_fwd_plain(q, k, v, scale, causal=True, window=window,
                                                 logit_softcap=softcap)
            else:
                attn = flash_attention_forward(q, k, v, softmax_scale=scale, causal=True,
                                               window=window, logit_softcap=softcap)
            if quant:
                quantize_append(k, v, *cache.layer(li), write_at)
            elif cache is not None:
                cache.k[li, :, :, :s] = k
                cache.v[li, :, :, :s] = v
        elif quant:
            kc, vc = cache.layer(li)
            quantize_append(k, v, kc, vc, write_at)
            if mode == "extend":
                # Dense extend over the dequantized layer slab (JAX's route).
                attn = _extend(q, dequantize_kv(kc, q.dtype), dequantize_kv(vc, q.dtype),
                               cache.lengths, new_len, scale, window, softcap, plain_attention)
            else:
                decode = (flash_attention_decode_quantized_plain if plain_attention
                          else flash_attention_decode_quantized)
                attn = decode(q, kc, vc, kv_length=new_len, sm_scale=scale, window=window,
                              logit_softcap=softcap)
        else:
            cache.k[li][rows, heads, slots] = k.to(cache.k.dtype)
            cache.v[li][rows, heads, slots] = v.to(cache.v.dtype)
            if mode == "extend":
                attn = _extend(q, cache.k[li].to(q.dtype), cache.v[li].to(q.dtype),
                               cache.lengths, new_len, scale, window, softcap, plain_attention)
            else:
                decode = (flash_attention_decode_plain if plain_attention
                          else flash_attention_decode)
                attn = decode(q, cache.k, cache.v, kv_length=new_len, sm_scale=scale,
                              window=window, logit_softcap=softcap, layer=li)
        x = L.layer_tail(x, attn, lp, cfg)

    x = L.rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
    out = x if return_hidden else L.logits(x, params, cfg)
    if cache is None:
        return out, None
    return out, dataclasses.replace(cache, lengths=cache.lengths + s)


def _extend(q, k, v, q_offset, kv_length, scale, window, softcap, plain_attention):
    """The chunk's attention over one layer's cache [B, Hkv, C, D]."""
    if plain_attention:
        return flash_attention_chunked_plain(q, k, v, q_offset, kv_length, scale,
                                             window=window, logit_softcap=softcap)
    return flash_attention_forward(q, k, v, softmax_scale=scale, causal=True,
                                   kv_length=kv_length, q_offset=q_offset, window=window,
                                   logit_softcap=softcap)


def init_params(
    cfg: ModelConfig,
    seed: int = 0,
    generator: torch.Generator | None = None,
    device="cuda",
) -> dict:
    """Random parameters for tests and benchmarks, drawn on `device` from
    `generator` (or a new one seeded with `seed`). Projections are normal
    with std fan_in ** -0.5, embeddings with std 0.02, norms are ones (the
    sandwich norms of `cfg.sandwich_norms` too). With
    `cfg.attention_bias` the q/k/v biases are normal with std BIAS_STD,
    drawn after every other tensor (so the other tensors do not depend on
    the flag); the JAX package's init sets them to zeros, which would leave
    the bias path untested. Each stacked weight is drawn one layer at a
    time in fp32 and cast, so the fp32 staging stays one layer's size."""
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
    if cfg.sandwich_norms:
        params["layers"]["pre_ffw_ln"] = ones(nl, e)
        params["layers"]["post_ffw_ln"] = ones(nl, e)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal((e, cfg.vocab_size), e ** -0.5)
    if cfg.attention_bias:
        for name, width in (("q_bias", hq), ("k_bias", hkv), ("v_bias", hkv)):
            params["layers"][name] = normal((nl, width), BIAS_STD)
    return params


def init_params_host(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters drawn with numpy on the host, then moved to
    `device`: the JAX package's `init_params_host`, the same generator
    (`numpy.random.default_rng(seed)`), draw order and scales, so each
    tensor equals the JAX array bit for bit. As there, a stacked weight's
    scale is `shape[0] ** -0.5` (its layer count), embeddings have std
    0.02, norms are ones and q/k/v biases zeros."""
    rng = np.random.default_rng(seed)
    e, f = cfg.hidden_size, cfg.intermediate_size
    hq = cfg.num_q_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    nl = cfg.num_layers

    def norm(shape, scale=None):
        scale = scale or (shape[0] ** -0.5)
        a = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(a).to(device=device, dtype=cfg.dtype)

    def fill(value, *shape):
        return torch.full(shape, value, dtype=cfg.dtype, device=device)

    layers = {
        "input_ln": fill(1, nl, e),
        "post_ln": fill(1, nl, e),
        "q_proj": norm((nl, e, hq)),
        "k_proj": norm((nl, e, hkv)),
        "v_proj": norm((nl, e, hkv)),
        "o_proj": norm((nl, hq, e)),
        "gate_proj": norm((nl, e, f)),
        "up_proj": norm((nl, e, f)),
        "down_proj": norm((nl, f, e)),
    }
    if cfg.attention_bias:
        layers.update(q_bias=fill(0, nl, hq), k_bias=fill(0, nl, hkv), v_bias=fill(0, nl, hkv))
    if cfg.sandwich_norms:
        layers.update(pre_ffw_ln=fill(1, nl, e), post_ffw_ln=fill(1, nl, e))
    params = {"embed": norm((cfg.vocab_size, e), scale=0.02), "layers": layers,
              "final_ln": fill(1, e)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = norm((e, cfg.vocab_size))
    return params
