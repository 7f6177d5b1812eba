"""Chunked extend over a contiguous KV cache: the CUDA kernel B4 and its
plain version.

Port of flash_attention_cute_tpu/ops/flash_chunked.py. A chunk of S new
queries per batch row attends the cache [B, Hkv, C, D] at full capacity C,
with the chunk's K/V already written at [q_offset, q_offset + S):

  * `q_offset [B]`: global position of the chunk's first query row;
    with `causal`, key n is visible from row r iff `n <= q_offset + r`
    (top-left causality in global positions).
  * `kv_length [B]`: valid cache length including the chunk, clamped to C;
    keys at or past it are masked. A row with no visible key, and a batch
    row of kv_length 0, outputs exact zeros.
  * `window`: a sliding window W also masks keys `n <= q_offset + r - W`.

Both are device tensors read by the kernel, so one kernel serves every fill
level and no host sync sizes the grid. `flash_attention_chunked` routes on
the device of `q`: a CPU tensor takes the plain version (the fp32
reference), a CUDA tensor launches B4 (csrc/flash_chunked.cu: wgmma fed by
TMA, the GQA group's heads packed into a block where their rows fit),
which replaces the TPU kernel `_flash_chunked_kernel`. Both take the tanh
soft cap (Gemma2's 50) and every head dim from 1 to 512
(`_build.padded_head_dim(..., wide=True)`: D 96 runs in D 128's layout, its
columns past 96 zeros, as the TPU wrapper pads D to its 128 lanes; D
257-512 in the wide layout of 512, csrc/attention_wgmma.cuh; rows at a
16-byte stride, q or a cache that breaks it taking one padded copy,
`_build.rows`, and the outputs at `_build.row_pitch(D)`). What the kernel
does not take raises; nothing falls back. Cache positions at or past a row's
length may hold uninitialised memory, even NaN: the kernel masks their
scores and zeroes their V rows before P V, and the plain version zeroes
them out of its products. With `return_partials` a CUDA tensor launches
B4's partials instantiations (counted apart, as `PARTIALS`): the (o, m, l)
state that ring attention folds (parallel/sequence.py). The TPU-only
arguments `block_q`, `block_kv`, `interpret` and `debug` are gone.
"""

from __future__ import annotations

import math

import torch

from flash_attention_cute_tpu_torch.ops import _build
from flash_attention_cute_tpu_torch.ops.reference import (
    attention_partials_reference,
    attention_reference,
)

LOG2E = math.log2(math.e)

P, I, L, F = _build.P, _build.I, _build.L, _build.F
CHUNKED = _build.Kernel(
    "flash_chunked", "flash_chunked.cu", "fact_flash_chunked",
    [P] * 6 + [I] * 6 + [L] * 9 + [F, F, I, I, I, P],
)
PARTIALS = _build.Kernel(
    "B4-partials", "flash_chunked.cu", "fact_flash_chunked_partials",
    [P] * 8 + [I] * 6 + [L] * 9 + [F, F, I, I, I, P],
)


def kernel_report() -> str:
    """Registers, spill bytes and shared memory of every B4 kernel
    instantiation, as the card's runtime reports them."""
    return _build.runtime_report(CHUNKED.source, "fact_chunked_report")


def flash_attention_chunked_plain(q, k, v, q_offset, kv_length, sm_scale=None, causal=True,
                                  window=None, logit_softcap=None, return_partials=False):
    """Plain version of B4 on any device: the fp32 reference with per-row
    offsets, kv_length clamped to the capacity (the TPU wrapper's
    `min(kv_length, C)`). With `return_partials`, the JAX kernel's
    (o_unnorm, m, l) in fp32, m in log2 units."""
    kvl = kv_length.to(device=q.device, dtype=torch.int32).clamp(0, k.shape[2])
    qo = q_offset.to(device=q.device, dtype=torch.int32)
    fn = attention_partials_reference if return_partials else attention_reference
    return fn(q, k, v, softmax_scale=sm_scale, causal=causal, kv_length=kvl, q_offset=qo,
              window=window, logit_softcap=logit_softcap)


def flash_attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: torch.Tensor,
    kv_length: torch.Tensor,
    sm_scale: float | None = None,
    causal: bool = True,
    window: int | None = None,
    logit_softcap: float | None = None,
    return_partials: bool = False,
):
    """Chunked-prefill attention over a partly filled contiguous cache.

    Args:
      q: [B, Hq, S, D], the chunk's queries; any strides with the head dim
        contiguous (the model hands in transposed views).
      k, v: [B, Hkv, C, D], the cache at full capacity with the chunk's K/V
        written; Hq % Hkv == 0; any strides with the head dim contiguous.
      q_offset: [B] int global position of q row 0.
      kv_length: [B] int valid cache length including the chunk.
      sm_scale: defaults to D ** -0.5.
      causal: top-left causality in global positions; False keeps only the
        length mask.
      window: sliding window W: row r also masks keys n <= q_offset + r - W.
      logit_softcap: tanh soft cap c (Gemma2's 50): scores become
        c * tanh(s / c) before the mask.
      return_partials: return the unnormalised online-softmax state that
        ring attention folds: (o_unnorm [B, Hq, S, D] f32, m [B, Hq, S] f32
        in log2 units of the scaled (and capped) scores, l [B, Hq, S] f32),
        m = max(0, the row's largest visible score), so a row with no
        visible key is m = 0, l = 0, o_unnorm = 0.

    Returns [B, Hq, S, D] in q's dtype (or the partials), on CUDA at rows
    of `_build.row_pitch(D)`: contiguous where D is a multiple of 8.
    """
    b, hq, sq, d = q.shape
    _, hkv, cap, _ = k.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_chunked_plain(q, k, v, q_offset, kv_length, sm_scale, causal,
                                             window, logit_softcap, return_partials)
    softcap = _build.softcap_arg(logit_softcap)
    window = _build.window_arg(window)
    if q.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(f"extend kernel takes bf16/f16, got {q.dtype}")
    _build.padded_head_dim(d, "extend", wide=True)
    if hq % hkv or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    q = _build.rows("q", q, q.dtype)
    k, v = _build.rows("k", k, q.dtype, "cache"), _build.rows("v", v, q.dtype, "cache")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    rows = []
    for name, t in (("q_offset", q_offset), ("kv_length", kv_length)):
        if t.device != q.device or t.shape != (b,) or t.dtype.is_floating_point:
            raise ValueError(f"{name} must be a [{b}] integer tensor on q's device")
        rows.append(t.to(torch.int32).contiguous())

    args = (rows[0].data_ptr(), rows[1].data_ptr(), b, hq, hkv, sq, cap, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(sm_scale) * LOG2E, softcap, int(causal), window, _build.DTYPE_CODES[q.dtype])
    if return_partials:
        o = _build.out_rows((b, hq, sq, d), torch.float32, q.device, _build.row_pitch(d))
        m, l = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) for _ in "ml")
        if o.numel():
            with torch.cuda.device(q.device):
                PARTIALS(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
                         l.data_ptr(), *args)
        return o, m, l
    out = _build.out_rows((b, hq, sq, d), q.dtype, q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        CHUNKED(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *args)
    return out
