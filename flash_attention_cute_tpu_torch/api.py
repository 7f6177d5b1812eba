"""User-facing attention API.

`flash_attn_func(q, k, v, softmax_scale=None, causal=False)` takes the
[batch, heads, seq, head_dim] layout of the JAX package. Routing:

  * seqlen_q == 1 (decode) -> split-KV decode (ops/flash_decode.py),
    causality being vacuous under bottom-right alignment.
  * kv_length / q_offset with seqlen_q > 1 (extend into a partly filled
    cache) -> the fp32 reference on the CPU; on CUDA it raises until the
    chunked kernel is ported (ROADMAP.md A6).
  * otherwise (prefill) -> the prefill forward (ops/flash_fwd.py).

Each op chooses kernel or plain version by the device of its tensors. This
slice is forward only: the autograd route arrives with the training slice.
"""

from __future__ import annotations

import torch

from flash_attention_cute_tpu_torch import dispatch
from flash_attention_cute_tpu_torch.ops.flash_decode import flash_attention_decode
from flash_attention_cute_tpu_torch.ops.flash_fwd import flash_attention_fwd
from flash_attention_cute_tpu_torch.ops.reference import attention_reference


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    softmax_scale: float | None = None,
    causal: bool = False,
    kv_length: torch.Tensor | None = None,
    q_offset: torch.Tensor | None = None,
    window: int | None = None,
    *,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """Dispatching attention forward. See `flash_attn_func`.

    `kv_length` ([B] int32) marks the valid prefix of k/v; `q_offset` ([B]
    int32) is the global position of q row 0 (causality becomes
    `col <= q_offset + row`); `window` is the sliding window (HF semantics).
    """
    dispatch.validate_inputs(q, k, v)
    _, _, sq, d = q.shape
    cfg = dispatch.select_block_config(
        dtype=q.dtype, head_dim=d, q_len=sq, kv_len=k.shape[2], causal=causal,
    )
    if sq == 1:
        return flash_attention_decode(
            q, k, v, kv_length=kv_length, sm_scale=softmax_scale, window=window,
            logit_softcap=logit_softcap, num_splits=cfg.decode_num_splits,
        )
    if kv_length is not None or q_offset is not None:
        if q.device.type != "cpu":
            raise NotImplementedError(
                "extend (kv_length / q_offset with seqlen_q > 1) on CUDA is "
                "ROADMAP.md A6 (flash_chunked)"
            )
        return attention_reference(
            q, k, v, softmax_scale=softmax_scale, causal=causal,
            kv_length=kv_length, q_offset=q_offset, window=window,
            logit_softcap=logit_softcap,
        )
    return flash_attention_fwd(
        q, k, v, sm_scale=softmax_scale, causal=causal, window=window,
        logit_softcap=logit_softcap,
    )


def flash_attn_func(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    softmax_scale: float | None = None,
    causal: bool = False,
    **kwargs,
) -> torch.Tensor:
    """Attention over q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D].

    softmax_scale defaults to head_dim ** -0.5; causal is bottom-right
    aligned. Returns [B, Hq, Sq, D] in q's dtype.
    """
    if softmax_scale is None:
        softmax_scale = q.shape[-1] ** -0.5
    return flash_attention_forward(
        q, k, v, softmax_scale=softmax_scale, causal=causal, **kwargs
    )
