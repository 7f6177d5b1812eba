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

Both take the tanh soft cap (`logit_softcap`, Gemma2's 50) and every head
dim from 1 to 512 (`_build.padded_head_dim(..., wide=True)`: D 96 runs in
D 128's layout, its columns past 96 read as zeros; D 257-512 in the wide
layout of 512, DeepSeek-V4's D 512 among them). Rows reach the kernels at a 16-byte
stride: q, k and v whose strides break that rule take one padded copy
(`_build.rows`, counted in `_build.copies`), and the output is allocated
at the row pitch `_build.row_pitch(d)` (`_build.out_rows`: a view of d
columns, contiguous where d is a multiple of 8). With
`return_lse` either kernel also writes the per-row log-sum-exp the
backward needs (ops/flash_bwd.py), in the TPU kernels'
convention: log2 units of the scaled scores, +inf on a row with no visible
key, at every head dim and with the cap, as the JAX forward returns it
(the backward kernels take the same head dims but not the cap: api.py
keeps a capped prefill forward-only).

With `score_dtype="int8"` (opt-in, forward only, as in the JAX package)
the scores Q K^T are an int8 product, at head dims from 1 to 256: K8
(`QUANTIZE_K`, `quantize_k_rows`) quantizes each K row once a call (b =
max |k_row|, replacing the TPU kernels' `_quantize_k_rows`), and P-i8 /
B2-i8 (`PREFILL_INT8`,
`WINDOWED_PREFILL_INT8`, the same P / B2 split by window) quantize each
pre-scaled q row in the kernel and run S as an s8 wgmma, s = i32 * b *
(a / 127) / 127 in base-2 units, before the cap, the mask and the softmax
of P / B2. q takes one scale a row (a = max |q_row|), where the TPU kernels
take one for a whole q tile: on the card each thread holds its rows' scores
anyway, and a row's own scale is the more accurate. The plain version
(`flash_attention_fwd_plain(..., score_dtype="int8")`) computes the same
scores and the exact softmax in fp32.

`stable` (True, "strict" or False) is accepted for the JAX signature: every
value runs the exact softmax (the kernels update the row max at every tile,
the `stable="strict"` semantics, and the plain version is exact), so none
changes the output. The TPU package's lazy and max-free modes are speed
knobs of its own softmax.

The kernel (wgmma fed by a TMA ring, csrc/flash_fwd.cu) reads q, k and v in
place through their strides, as `_build.check_cuda_tensor` takes them. What
it does not take raises; nothing falls back.
"""

from __future__ import annotations

import math

import torch

from flash_attention_cute_tpu_torch.ops import _build
from flash_attention_cute_tpu_torch.ops.reference import attention_reference, prefill_mask

LOG2E = math.log2(math.e)
# fp32(1 / 127), as the TPU kernels' `1.0 / 127.0` becomes in fp32.
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()

P, I, L, F = _build.P, _build.I, _build.L, _build.F
_ARGS = [P, P, P, P, P, I, I, I, I, I, I, L, L, L, L, L, L, L, L, L, F, F, I, I, I, P]
PREFILL = _build.Kernel("flash_fwd", "flash_fwd.cu", "fact_flash_fwd", _ARGS)
# The same launch function with a window that binds: counted as B2.
WINDOWED_PREFILL = _build.Kernel("flash_fwd_window", "flash_fwd.cu", "fact_flash_fwd", _ARGS)
# int8 scores: K8, then P-i8 (no binding window) or B2-i8 (one that binds).
QUANTIZE_K = _build.Kernel("quantize_k_rows", "flash_fwd.cu", "fact_quantize_k_rows",
                           [P, P, P, I, I, I, I, I, L, L, L, I, P])
_ARGS_INT8 = [P, P, P, P, P, P, I, I, I, I, I, I, I, L, L, L, L, L, L, F, F, I, I, I, P]
PREFILL_INT8 = _build.Kernel("flash_fwd_int8", "flash_fwd.cu", "fact_flash_fwd_int8", _ARGS_INT8)
WINDOWED_PREFILL_INT8 = _build.Kernel("flash_fwd_window_int8", "flash_fwd.cu",
                                      "fact_flash_fwd_int8", _ARGS_INT8)


def kernel_report() -> str:
    """Registers, spill bytes and shared memory of every P / B2 kernel
    instantiation, as the card's runtime reports them."""
    return _build.runtime_report(PREFILL.source, "fact_fwd_report")


def check_knobs(score_dtype, stable) -> None:
    """Raise on a `score_dtype` or `stable` the forward does not take."""
    if score_dtype not in (None, "int8"):
        raise ValueError(f"score_dtype must be 'int8' or None, got {score_dtype!r}")
    if not (stable is True or stable is False or stable == "strict"):
        raise ValueError(f"stable must be True, 'strict' or False, got {stable!r}")


def kscale_rows(skv: int) -> int:
    """Row length of K8's scales: Skv rounded up to 128, so that each tile's
    scales are one 16-byte aligned bulk copy (zeros past Skv)."""
    return max(128, -(-skv // 128) * 128)


def quantize_rows_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K8: per-row symmetric int8 quantization over the last
    dim, the formula of the TPU kernels' `_quantize_k_rows`: b = max |row|
    (1 where 0), values round(x * (127 / b)) clipped to +-127 (ties to
    even). Returns (int8 values, fp32 b), b of shape x.shape[:-1]."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    b = torch.where(amax == 0, torch.ones_like(amax), amax)
    # A tensor quotient: `127.0 / b` would multiply by b's reciprocal.
    mul = torch.full_like(b, 127.0) / b
    values = torch.clamp(torch.round(xf * mul[..., None]), -127, 127).to(torch.int8)
    return values, b


def quantize_k_rows(k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K8: the int8 rows of K and their scales b (`quantize_rows_plain`):
    int8 [B, Hkv, Skv, D] (on CUDA rows at `_build.row_pitch(D, 1)`, zeros
    past D), fp32 [B, Hkv, Skv]. A CPU tensor takes the plain version; a
    CUDA one launches the kernel (bf16 / f16, D 1 to 256, any strides with
    D contiguous), bit-identical to it."""
    if k.device.type == "cpu":
        return quantize_rows_plain(k)
    values, scales = _quantize_k_padded(k)
    return values, scales[..., : k.shape[2]]


def _quantize_k_padded(k):
    """K8's launch: values, and scales with rows of `kscale_rows(Skv)`."""
    b, hkv, skv, d = k.shape
    if k.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(f"K8 takes bf16/f16, got {k.dtype}")
    _build.padded_head_dim(d, "K8")
    k = _build.rows("k", k, k.dtype)
    rows = kscale_rows(skv)
    values = _build.out_rows((b, hkv, skv, d), torch.int8, k.device)
    scales = torch.empty((b, hkv, rows), dtype=torch.float32, device=k.device)
    if values.numel():
        with torch.cuda.device(k.device):
            QUANTIZE_K(k.data_ptr(), values.data_ptr(), scales.data_ptr(), b, hkv, skv, d, rows,
                       *k.stride()[:3], _build.DTYPE_CODES[k.dtype])
    return values, scales


def launch_int8(q, k8, kscale, v, out, lse, sm_scale, causal, window, softcap):
    """P-i8 (B2-i8 for window > 0) alone, over K8's values and padded
    scales (`_quantize_k_padded`), into `out` (and `lse` unless None);
    `window` and `softcap` as `_build.window_arg` / `softcap_arg` give
    them, a window of at least Skv already taken as 0."""
    b, hq, sq, d = q.shape
    _build.check_out_rows("out", out, _build.row_pitch(d))
    with torch.cuda.device(q.device):
        (WINDOWED_PREFILL_INT8 if window else PREFILL_INT8)(
            q.data_ptr(), k8.data_ptr(), kscale.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, hq, k8.shape[1], sq, k8.shape[2], d, kscale.shape[2], *q.stride()[:3],
            *v.stride()[:3], float(sm_scale) * LOG2E, softcap, int(causal), window,
            _build.DTYPE_CODES[q.dtype],
        )


def int8_scores_plain(q, k, sm_scale):
    """The int8 scores of P-i8 / B2-i8, fp32 [B, Hq, Sq, Skv] in base-2
    units: q times sm_scale * log2(e) in fp32, rounded to q's type (the
    TPU wrapper's pre-scale), quantized per row (a), K per row (b), and
    s = i32 * (b * ((a / 127) / 127)) as the TPU kernels' `_int8_scores`
    reconstruct it (the int8 products summed in fp32 are exact integers:
    |s| <= 127^2 D < 2^24)."""
    hq, hkv = q.shape[1], k.shape[1]
    scale = torch.tensor(sm_scale * LOG2E, dtype=torch.float32).item()
    q8, a = quantize_rows_plain((q.float() * scale).to(q.dtype))
    k8, b = quantize_rows_plain(k)
    rq = (a * _INV127) * _INV127
    if hq != hkv:
        k8 = k8.repeat_interleave(hq // hkv, dim=1)
        b = b.repeat_interleave(hq // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q8.float(), k8.float())
    return s * (b[:, :, None, :] * rq[..., None])


def int8_attention_plain(q, k, v, sm_scale, causal, window, logit_softcap, return_lse,
                         out_dtype=None):
    """Attention over `int8_scores_plain`: the cap c log2(e) tanh(s / (c
    log2(e))) of the base-2 scores, the mask, and the exact base-2
    softmax in fp32; rows with no visible key are zeros with lse +inf. The
    output in `out_dtype` (q's dtype for None: fp32 spares a comparison the
    plain version's own rounding)."""
    hq, sq, skv = q.shape[1], q.shape[2], k.shape[2]
    s = int8_scores_plain(q, k, sm_scale)
    if logit_softcap is not None:
        cap2 = logit_softcap * LOG2E
        s = torch.tanh(s * (1.0 / cap2)) * cap2
    allowed = prefill_mask(sq, skv, causal, window, device=q.device)
    s = s.masked_fill(~allowed, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True)
    vf = v.float()
    if hq != v.shape[1]:
        vf = vf.repeat_interleave(hq // v.shape[1], dim=1)
    # Keys no row reads get weight 0, and 0 * NaN is NaN: zero their values.
    vf = torch.where(allowed.any(dim=0)[:, None], vf, torch.zeros((), device=q.device))
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    out = torch.where(l > 0, o / l, torch.zeros((), device=q.device)).to(out_dtype or q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l[..., 0] > 0, m[..., 0] + torch.log2(l[..., 0]), math.inf)
    return out, lse


def flash_attention_fwd_plain(
    q, k, v, sm_scale=None, causal=False, window=None, logit_softcap=None, return_lse=False,
    score_dtype=None,
):
    """Plain version of kernels P and B2 on any device: the fp32 reference
    (with `return_lse`, also its fp32 lse); with `score_dtype="int8"`, of
    P-i8 and B2-i8: `int8_attention_plain`."""
    if score_dtype == "int8":
        if sm_scale is None:
            sm_scale = q.shape[-1] ** -0.5
        return int8_attention_plain(q, k, v, sm_scale, causal, window, logit_softcap,
                                    return_lse)
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
    *,
    stable: bool | str = True,
    score_dtype: str | None = None,
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
      stable: True, "strict" or False; every mode runs the exact softmax
        (see the module docstring).
      score_dtype: None, or "int8" for int8 scores (P-i8 / B2-i8 after K8
        on CUDA); the lse is then that of the int8 scores.

    Returns [B, Hq, Sq, D] in q's dtype (on CUDA rows at
    `_build.row_pitch(D)`: contiguous where D is a multiple of 8); (out,
    lse) with `return_lse`.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    check_knobs(score_dtype, stable)
    if sm_scale is None:
        sm_scale = d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, sm_scale, causal, window, logit_softcap,
                                         return_lse, score_dtype)
    softcap = _build.softcap_arg(logit_softcap)
    window = _build.window_arg(window)
    if window >= skv:
        window = 0  # cannot bind: P's geometry
    if q.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(f"prefill kernel takes bf16/f16, got {q.dtype}")
    int8 = score_dtype == "int8"
    _build.padded_head_dim(d, "int8-score prefill" if int8 else "prefill", wide=not int8)
    if hq % hkv or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    q, k, v = (_build.rows(name, t, q.dtype) for name, t in (("q", q), ("k", k), ("v", v)))
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")

    out = _build.out_rows((b, hq, sq, d), q.dtype, q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if int8:
        k8, kscale = _quantize_k_padded(k)
        launch_int8(q, k8, kscale, v, out, lse, sm_scale, causal, window, softcap)
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
