"""Model forward over a paged KV cache: the serving engine's data path.

Port of flash_attention_cute_tpu/runtime/paged_forward.py for the Llama
family, Qwen2, Mistral and Gemma2 included. Per layer, the fresh K/V are
written into the page pool through the page table (`paged_append_layer`,
the append kernel on CUDA), then attention runs with the layer's sliding
window (`ModelConfig.layer_window`, JAX's `make_layer(window)`) and the
model's soft cap (`cfg.logit_softcap`, Gemma2; every kernel of this path,
bf16 or quantized, takes the cap and head dim 256):

  * prefill: a fresh request (lengths 0): causal attention over the chunk's
    own K/V (kernel P on CUDA, B2 where a window binds). Prompts may be
    padded; lengths advance by `valid_len`, and padded positions write K/V
    that no later read sees.
  * extend: chunked admission: the S rows sit at global positions lengths
    .. lengths + S and attend the paged prefix plus themselves (kernel B6).
  * decode: one token per row: paged decode attention over the advanced
    lengths (kernels B5 + D2). Rows of length 0 are inactive: they write
    nothing, their length stays 0 and their output is discarded.

A `QuantizedPagedKVState` takes the quantized route: the append quantizes
each new row per token (kernel QA), extend runs B9 and decode B8 + D2 over
the int8 / e4m3 pages; prefill still attends the fresh K/V (kernel P).

The pools are updated in place, where the JAX version donates them: the
returned state shares its pools with the one passed in.
"""

from __future__ import annotations

import dataclasses

import torch

from flash_attention_cute_tpu_torch.api import flash_attention_forward
from flash_attention_cute_tpu_torch.models import layers as L
from flash_attention_cute_tpu_torch.models.config import ModelConfig
from flash_attention_cute_tpu_torch.ops.flash_fwd import flash_attention_fwd_plain
from flash_attention_cute_tpu_torch.ops.paged_attention import (
    paged_attention_decode,
    paged_attention_decode_plain,
    paged_attention_extend,
    paged_attention_extend_plain,
)
from flash_attention_cute_tpu_torch.ops.quantized import (
    paged_attention_decode_quantized,
    paged_attention_decode_quantized_plain,
    paged_attention_extend_quantized,
    paged_attention_extend_quantized_plain,
    quantize_append,
)
from flash_attention_cute_tpu_torch.runtime.paged_cache import (
    PagedKVState,
    QuantizedPagedKVState,
    paged_append_layer,
)


def forward_paged(
    params: dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,
    state: PagedKVState | QuantizedPagedKVState,
    mode: str = "decode",
    valid_len: torch.Tensor | None = None,
    plain_attention: bool = False,
) -> tuple[torch.Tensor, PagedKVState | QuantizedPagedKVState]:
    """Returns (logits [B, S, V] fp32, updated state).

    Args:
      input_ids: [B, S] on the parameters' device.
      state: the paged state, dense or quantized; its pools are written in
        place.
      mode: "prefill" | "extend" | "decode" (S must be 1).
      valid_len: [B] real (unpadded) lengths in prefill and extend (default
        S); ignored in decode, where rows with length > 0 advance by 1.
      plain_attention: run attention through the kernels' plain PyTorch
        versions whatever the device (the comparison path).
    """
    if mode not in ("prefill", "decode", "extend"):
        raise ValueError(f"unknown mode {mode!r}")
    b, s = input_ids.shape
    if mode == "decode" and s != 1:
        raise ValueError(f"mode='decode' takes one token per row, got {s}")
    x = L.embed(params, input_ids, cfg)
    dev = x.device

    lengths = state.lengths
    steps = torch.arange(s, dtype=torch.int32, device=dev)
    if mode == "prefill":
        positions = steps.expand(b, s)
        if valid_len is None:
            valid_len = torch.full((b,), s, dtype=torch.int32, device=dev)
    elif mode == "extend":
        positions = lengths[:, None] + steps
        if valid_len is None:
            valid_len = torch.full((b,), s, dtype=torch.int32, device=dev)
    else:
        positions = lengths[:, None] + steps
        # Only active rows (length > 0 after their prefill) advance; empty
        # slots stay at 0 and the kernel emits zeros for them.
        valid_len = (lengths > 0).to(torch.int32)
    cos, sin = L.rope_cos_sin(positions, L.rope_inv_freq(cfg, dev), cfg.dtype)
    # Rows that do not advance (empty slots, and slots mid chunked admission
    # whose tables already hold real pages) write nothing.
    active = valid_len > 0
    new_len = lengths + valid_len
    scale, softcap = cfg.attention_scale, cfg.logit_softcap
    table = state.page_table
    quant = isinstance(state, QuantizedPagedKVState)
    # Attention of extend and decode: (kernel route, plain route).
    if mode == "extend":
        attend = ((paged_attention_extend_quantized, paged_attention_extend_quantized_plain)
                  if quant else (paged_attention_extend, paged_attention_extend_plain))
    else:
        attend = ((paged_attention_decode_quantized, paged_attention_decode_quantized_plain)
                  if quant else (paged_attention_decode, paged_attention_decode_plain))
    attend = attend[plain_attention]

    for li in range(cfg.num_layers):
        lp = {name: w[li] for name, w in params["layers"].items()}
        window = cfg.layer_window(li)
        h = L.rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
        q, k, v = L.qkv_project(h, lp, cfg)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
        # One layer's pools: views, written in place.
        if quant:
            kp, vp = state.layer(li)
            quantize_append(k, v, kp, vp, lengths, table, active)
        else:
            kp, vp = state.k_pages[li], state.v_pages[li]
            paged_append_layer(kp, vp, k, v, table, lengths, active)
        if mode == "prefill":
            if plain_attention:
                attn = flash_attention_fwd_plain(q, k, v, scale, causal=True, window=window,
                                                 logit_softcap=softcap)
            else:
                attn = flash_attention_forward(q, k, v, softmax_scale=scale, causal=True,
                                               window=window, logit_softcap=softcap)
        elif mode == "extend":
            attn = attend(q, kp, vp, new_len - s, new_len, table, sm_scale=scale, window=window,
                          logit_softcap=softcap)
        else:
            attn = attend(q, kp, vp, new_len, table, sm_scale=scale, window=window,
                          logit_softcap=softcap)
        x = L.layer_tail(x, attn, lp, cfg)

    x = L.rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
    logits = L.logits(x, params, cfg)
    return logits, dataclasses.replace(state, lengths=new_len)
