"""Prefill attention forward: the CUDA kernel P and its plain version.

`flash_attention_fwd` routes on the device of `q`: a CPU tensor takes the
plain version (the fp32 reference), a CUDA tensor launches kernel P
(csrc/flash_fwd.cu), which replaces the TPU kernel `_flash_fwd_kernel_diag`
of flash_attention_cute_tpu/ops/flash_fwd.py. What the kernel does not take
raises; nothing falls back.
"""

from __future__ import annotations

import math

import torch

from flash_attention_cute_tpu_torch.ops import _build
from flash_attention_cute_tpu_torch.ops.reference import attention_reference

LOG2E = math.log2(math.e)
HEAD_DIMS = (64, 128)

P, I, L, F = _build.P, _build.I, _build.L, _build.F
PREFILL = _build.Kernel(
    "flash_fwd", "flash_fwd.cu", "fact_flash_fwd",
    [P, P, P, P, I, I, I, I, I, I, L, L, L, L, L, L, L, L, L, F, I, I, P],
)


def flash_attention_fwd_plain(
    q, k, v, sm_scale=None, causal=False, window=None, logit_softcap=None
) -> torch.Tensor:
    """Plain version of kernel P on any device: the fp32 reference."""
    return attention_reference(
        q, k, v, softmax_scale=sm_scale, causal=causal, window=window,
        logit_softcap=logit_softcap,
    )


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float | None = None,
    causal: bool = False,
    window: int | None = None,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """Attention forward for prefill.

    Args:
      q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D], Hq % Hkv == 0. Any strides
        with the head dim contiguous (the model hands in transposed views).
      sm_scale: defaults to D ** -0.5.
      causal: bottom-right-aligned causal masking; rows with no visible key
        (Sq > Skv) are exact zeros.
      window, logit_softcap: plain version only (ROADMAP.md B2).

    Returns [B, Hq, Sq, D] in q's dtype, contiguous.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, sm_scale, causal, window, logit_softcap)
    if window is not None or logit_softcap is not None:
        raise NotImplementedError(
            "window / logit_softcap prefill on CUDA is ROADMAP.md B2 "
            "(_flash_fwd_kernel_fused)"
        )
    if q.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(f"prefill kernel takes bf16/f16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"prefill kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if hq % hkv or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_cuda_tensor(name, t, q.dtype)
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")

    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        PREFILL(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, sq, skv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(sm_scale) * LOG2E, int(causal), _build.DTYPE_CODES[q.dtype],
        )
    return out
