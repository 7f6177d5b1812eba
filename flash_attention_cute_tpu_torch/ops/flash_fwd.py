"""Prefill attention forward: the CUDA kernels P and B2 and their plain
version.

`flash_attention_fwd` routes on the device of `q`: a CPU tensor takes the
plain version (the fp32 reference), a CUDA tensor launches the kernel of
csrc/flash_fwd.cu, counted as one of two kernels of the TPU package's
flash_attention_cute_tpu/ops/flash_fwd.py:

  * P (`PREFILL`): no window, or a window of at least Skv, which can never
    bind (p - W < 0 <= n for every key; the JAX wrapper drops it the same
    way). Replaces `_flash_fwd_kernel_diag`.
  * B2 (`WINDOWED_PREFILL`): a sliding window W < Skv, key n visible from
    row m iff n > m + (Skv - Sq) - W (and causal / in range); each block
    walks only the tiles its rows' windows reach. Replaces the windowed
    geometry of `_flash_fwd_kernel_fused` and `_flash_fwd_kernel`.

Both take the tanh soft cap (`logit_softcap`, Gemma2's 50) and head dims
64, 128 and 256. With `return_lse` either kernel also writes the per-row
log-sum-exp the backward needs (ops/flash_bwd.py), in the TPU kernels'
convention: log2 units of the scaled scores, +inf on a row with no visible
key, at every head dim and with the cap, as the JAX forward returns it
(the backward kernels take neither: ops/autodiff.py refuses D 256 on CUDA
before the forward runs).

The kernel (wgmma fed by a TMA ring, csrc/flash_fwd.cu) reads q, k and v in
place through their strides, as `_build.check_cuda_tensor` takes them. What
it does not take raises; nothing falls back.
"""

from __future__ import annotations

import math

import torch

from flash_attention_cute_tpu_torch.ops import _build
from flash_attention_cute_tpu_torch.ops.reference import attention_reference

LOG2E = math.log2(math.e)
HEAD_DIMS = (64, 128, 256)

P, I, L, F = _build.P, _build.I, _build.L, _build.F
_ARGS = [P, P, P, P, P, I, I, I, I, I, I, L, L, L, L, L, L, L, L, L, F, F, I, I, I, P]
PREFILL = _build.Kernel("flash_fwd", "flash_fwd.cu", "fact_flash_fwd", _ARGS)
# The same launch function with a window that binds: counted as B2.
WINDOWED_PREFILL = _build.Kernel("flash_fwd_window", "flash_fwd.cu", "fact_flash_fwd", _ARGS)


def kernel_report() -> str:
    """Registers, spill bytes and shared memory of every P / B2 kernel
    instantiation, as the card's runtime reports them."""
    return _build.runtime_report(PREFILL.source, "fact_fwd_report")


def flash_attention_fwd_plain(
    q, k, v, sm_scale=None, causal=False, window=None, logit_softcap=None, return_lse=False
):
    """Plain version of kernels P and B2 on any device: the fp32 reference
    (with `return_lse`, also its fp32 lse)."""
    return attention_reference(
        q, k, v, softmax_scale=sm_scale, causal=causal, window=window,
        logit_softcap=logit_softcap, return_lse=return_lse,
    )


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float | None = None,
    causal: bool = False,
    window: int | None = None,
    logit_softcap: float | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Attention forward for prefill.

    Args:
      q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D], Hq % Hkv == 0. Any strides
        with the head dim contiguous (the model hands in transposed views).
      sm_scale: defaults to D ** -0.5.
      causal: bottom-right-aligned causal masking; rows with no visible key
        (Sq > Skv) are exact zeros.
      window: sliding window W (HF semantics): row m also masks keys
        n <= m + (Skv - Sq) - W. On CUDA a binding window runs B2.
      logit_softcap: tanh soft cap c of the scaled scores, c * tanh(s / c),
        before the mask (Gemma2); None for none.
      return_lse: also return the lse [B, Hq, Sq] fp32: log2 of the row's
        sum of 2^(s * log2(e)) over its visible scaled scores s, +inf on a
        row with no visible key (the JAX package's `return_lse`).

    Returns [B, Hq, Sq, D] in q's dtype, contiguous; (out, lse) with
    `return_lse`.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, sm_scale, causal, window, logit_softcap,
                                         return_lse)
    softcap = _build.softcap_arg(logit_softcap)
    window = _build.window_arg(window)
    if window >= skv:
        window = 0  # cannot bind: P's geometry
    if q.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(f"prefill kernel takes bf16/f16, got {q.dtype}")
    _build.check_head_dim(d, HEAD_DIMS, "prefill")
    if hq % hkv or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_cuda_tensor(name, t, q.dtype)
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")

    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    with torch.cuda.device(q.device):
        (WINDOWED_PREFILL if window else PREFILL)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None,
            b, hq, hkv, sq, skv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(sm_scale) * LOG2E, softcap, int(causal), window, _build.DTYPE_CODES[q.dtype],
        )
    return (out, lse) if return_lse else out
