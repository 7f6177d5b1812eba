"""User-facing attention API.

`flash_attn_func(q, k, v, softmax_scale=None, causal=False)` takes the
[batch, heads, seq, head_dim] layout of the JAX package. Routing:

  * seqlen_q == 1 (decode) -> split-KV decode (ops/flash_decode.py),
    causality being vacuous under bottom-right alignment.
  * kv_length / q_offset with seqlen_q > 1 (extend into a partly filled
    cache) -> the chunked extend (ops/flash_chunked.py, kernel B4 on
    CUDA). kv_length None means the full Skv; q_offset None means
    kv_length - seqlen_q (bottom-right alignment per row).
  * otherwise (prefill) -> the prefill forward (ops/flash_fwd.py). When
    autograd records (`torch.is_grad_enabled()` and q, k or v requires
    grad) and there is no soft cap, dense prefill goes through the
    differentiable op `ops.autodiff.flash_attention` instead: the same
    forward kernel with its lse, and the recompute backward kernels
    (ops/flash_bwd.py). The JAX package routes dense prefill at default
    knobs through its custom-VJP op the same way. Under `torch.no_grad`
    (serving, generation) the call is the plain forward, with no lse.
    A soft cap keeps prefill on the forward-only route, as in the JAX
    package; no backward kernel takes the cap, so under autograd a capped
    prefill of CUDA tensors raises (the kernel's output would carry no
    gradient), while CPU tensors take the plain version, which autograd
    differentiates. The other non-default knobs, `score_dtype="int8"` and
    a `stable` other than True, keep prefill forward-only the same way (the
    JAX package's rule).

`score_dtype="int8"` (int8 scores, ops/flash_fwd.py: K8 then P-i8 / B2-i8
on CUDA) is taken only by the dense prefill: the decode and extend routes
raise, as the JAX package's API does. `stable` is accepted for the JAX
signature; every value runs the exact softmax. (The JAX package's API
ignores `score_dtype` where it runs its fp32 reference instead of its
kernels; the port's CPU route follows its kernel route.)

Each op chooses kernel or plain version by the device of its tensors.
Decode and extend are forward only.
"""

from __future__ import annotations

import torch

from flash_attention_cute_tpu_torch import dispatch
from flash_attention_cute_tpu_torch.ops import autodiff, flash_fwd
from flash_attention_cute_tpu_torch.ops.flash_chunked import flash_attention_chunked
from flash_attention_cute_tpu_torch.ops.flash_decode import flash_attention_decode
from flash_attention_cute_tpu_torch.ops.flash_fwd import flash_attention_fwd


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
    stable: bool | str = True,
    logit_softcap: float | None = None,
    score_dtype: str | None = None,
) -> torch.Tensor:
    """Dispatching attention forward. See `flash_attn_func`.

    `kv_length` ([B] int32) marks the valid prefix of k/v; `q_offset` ([B]
    int32) is the global position of q row 0 (causality becomes
    `col <= q_offset + row`); `window` is the sliding window (HF semantics).
    `stable` (True, "strict" or False) names the JAX package's softmax
    modes; every one runs the exact softmax here. `score_dtype="int8"` opts
    the dense prefill into int8 scores (about 1e-2 of output error against
    bf16 scores: a speed / accuracy trade); other routes raise.
    """
    dispatch.validate_inputs(q, k, v)
    _, _, sq, d = q.shape
    if score_dtype is not None and (sq == 1 or kv_length is not None or q_offset is not None):
        raise ValueError(
            "score_dtype is supported only on the dense prefill path "
            "(decode / chunked-extend routes run bf16 scores)")
    flash_fwd.check_knobs(score_dtype, stable)
    cfg = dispatch.select_block_config(
        dtype=q.dtype, head_dim=d, q_len=sq, kv_len=k.shape[2], causal=causal,
    )
    if sq == 1:
        return flash_attention_decode(
            q, k, v, kv_length=kv_length, sm_scale=softmax_scale, window=window,
            logit_softcap=logit_softcap, num_splits=cfg.decode_num_splits,
        )
    if kv_length is not None or q_offset is not None:
        if kv_length is None:
            kv_length = torch.full((q.shape[0],), k.shape[2], dtype=torch.int32,
                                   device=q.device)
        if q_offset is None:
            q_offset = kv_length - sq
        return flash_attention_chunked(
            q, k, v, q_offset, kv_length, sm_scale=softmax_scale, causal=causal,
            window=window, logit_softcap=logit_softcap,
        )
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if logit_softcap is None and score_dtype is None and stable is True:
            return autodiff.flash_attention(q, k, v, sm_scale=softmax_scale, causal=causal,
                                            window=window)
        if q.device.type != "cpu":
            if logit_softcap is not None:
                raise NotImplementedError(
                    "a soft-capped prefill under autograd: no backward kernel takes the soft "
                    "cap (ROADMAP.md A10b); run it under torch.no_grad()")
            raise NotImplementedError(
                f"score_dtype={score_dtype!r} / stable={stable!r} keep prefill forward-only "
                "(as in the JAX package): run it under torch.no_grad()")
    return flash_attention_fwd(
        q, k, v, sm_scale=softmax_scale, causal=causal, window=window,
        logit_softcap=logit_softcap, stable=stable, score_dtype=score_dtype,
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
