"""Attention over a packed ragged batch: the CUDA kernel B12 and its plain
version.

Port of flash_attention_cute_tpu/ops/flash_varlen.py. Sequences are packed
along one token axis and delimited by int32 metadata vectors:

  q tokens:  segment id (non-decreasing) and causal bound (the token's
             position in its sequence + kv_len - q_len of that sequence,
             so per-sequence bottom-right causality is `pos_kv <= bound`);
  kv tokens: segment id and position in the sequence (from 0).

`flash_attention_varlen` is the cu_seqlens front end ([T, H, D], the
flash-attn layout); `flash_attention_packed` is the core ([H, T, D]).
Both route on the device of `q`: a CPU tensor takes the plain version (per
segment dense attention in fp32, never a [Tq, Tkv] matrix), a CUDA tensor
launches B12 (csrc/flash_varlen.cu: wgmma fed by TMA), which replaces
`_flash_varlen_kernel`. Both take the tanh soft cap and every head dim
from 1 to 512 (`_build.padded_head_dim(..., wide=True)`: the kernel runs
a d in the layout of the next of 64, 128, 256 and 512; rows at a 16-byte stride, q, k or v that
break it taking one padded copy, `_build.rows`, and O at
`_build.row_pitch(d)`). The
metadata are derived and read on the device: no length, offset or segment
id becomes a Python int on the kernel route. Rows with no
visible key are exact zeros. `equal_lengths`, `max_seqlen`, `block_q`,
`block_kv` and `stable` (TPU grid and softmax knobs) are accepted and
ignored: the kernel finds each block's live key range itself and its
softmax is exact.
"""

from __future__ import annotations

import math

import torch

from flash_attention_cute_tpu_torch.ops import _build

LOG2E = math.log2(math.e)
# Keys past Tkv in the kernel's padded copy of the kv metadata: no row sees
# them (segment INT_MIN, position INT_MAX); a tile of 128 keys may start at
# any key below Tkv.
PAD_SEG, PAD_POS, PAD_KEYS = -(2 ** 31), 2 ** 31 - 1, 128

P, I, L, F = _build.P, _build.I, _build.L, _build.F
VARLEN = _build.Kernel("flash_varlen", "flash_varlen.cu", "fact_flash_varlen",
                       [P] * 7 + [I] * 6 + [L] * 6 + [F, F, I, I, I, P])


def kernel_report() -> str:
    """Registers, spill bytes and shared memory of every B12 kernel
    instantiation, as the card's runtime reports them."""
    return _build.runtime_report(VARLEN.source, "fact_varlen_report")


def kv_metadata(kv_seg: torch.Tensor, kv_pos: torch.Tensor) -> torch.Tensor:
    """The kernel's copy of the kv metadata: int32 [2, Tpad] (segment ids,
    then positions), padded past Tkv with keys no row sees to a length the
    kernel's 16-byte copies of a whole tile never overrun."""
    tkv = kv_seg.shape[0]
    tpad = -(-(tkv + PAD_KEYS) // 8) * 8
    meta = torch.empty((2, tpad), dtype=torch.int32, device=kv_seg.device)
    meta[0, tkv:] = PAD_SEG
    meta[1, tkv:] = PAD_POS
    meta[0, :tkv] = kv_seg
    meta[1, :tkv] = kv_pos
    return meta


def flash_attention_packed_plain(q, k, v, q_segment_ids, kv_segment_ids, q_bounds=None,
                                 kv_positions=None, sm_scale=None, causal=False, window=None,
                                 logit_softcap=None):
    """Plain version of B12 on any device: each segment's dense attention
    in fp32 under the packed mask, output [Hq, Tq, D] in q's dtype."""
    hq, tq, d = q.shape
    hkv = k.shape[0]
    scale = d ** -0.5 if sm_scale is None else sm_scale
    out = torch.zeros((hq, tq, d), dtype=torch.float32, device=q.device)
    ids, counts = torch.unique_consecutive(q_segment_ids, return_counts=True)
    kv_seg = kv_segment_ids.to(ids.dtype).contiguous()
    kv_lo = torch.searchsorted(kv_seg, ids).tolist()
    kv_hi = torch.searchsorted(kv_seg, ids, right=True).tolist()
    q_lo = 0
    for n, a, b in zip(counts.tolist(), kv_lo, kv_hi):
        rows = slice(q_lo, q_lo + n)
        q_lo += n
        qf = q[:, rows].float()
        kf = k[:, a:b].float().repeat_interleave(hq // hkv, dim=0)
        vf = v[:, a:b].float().repeat_interleave(hq // hkv, dim=0)
        s = torch.einsum("hqd,hkd->hqk", qf, kf) * scale
        if logit_softcap is not None:
            s = torch.tanh(s / logit_softcap) * logit_softcap
        allowed = torch.ones((n, b - a), dtype=torch.bool, device=q.device)
        if causal or window is not None:
            bound = q_bounds[rows, None]
            pos = kv_positions[None, a:b]
            if causal:
                allowed &= pos <= bound
            if window is not None:
                allowed &= pos > bound - window
        p = torch.softmax(s.masked_fill(~allowed, float("-inf")), dim=-1)
        p = torch.where(allowed.any(-1, keepdim=True), p, 0.0)  # no visible key: zeros
        out[:, rows] = torch.einsum("hqk,hkd->hqd", p, vf)
    return out.to(q.dtype)


def flash_attention_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    q_bounds: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    sm_scale: float | None = None,
    causal: bool = False,
    window: int | None = None,
    logit_softcap: float | None = None,
    equal_lengths: bool = False,
    max_seqlen: int = 0,
    block_q: int = 0,
    block_kv: int = 0,
    stable: bool | str = True,
) -> torch.Tensor:
    """Packed-segment attention core.

    Args:
      q: [Hq, Tq, D]; k, v: [Hkv, Tkv, D], Hq % Hkv == 0; any strides with
        the head dim contiguous.
      q_segment_ids [Tq], kv_segment_ids [Tkv]: int32, non-decreasing.
      q_bounds [Tq], kv_positions [Tkv]: int32, required when causal or with
        a window; kv positions count from 0 at a segment's first key, and
        bounds do not decrease within a segment (the varlen front end's
        pos + kv_len - q_len): the kernel bounds a run of rows of one
        segment by its first and last row. Segment ids are above INT_MIN.
      causal / window: `pos_kv <= bound` / `pos_kv > bound - window`.
      logit_softcap: tanh soft cap c: scores become c * tanh(s / c) before
        the mask.

    Returns [Hq, Tq, D] in q's dtype (on CUDA rows at
    `_build.row_pitch(D)`: contiguous where D is a multiple of 8).
    """
    hq, tq, d = q.shape
    hkv, tkv, _ = k.shape
    if (causal or window is not None) and (q_bounds is None or kv_positions is None):
        raise ValueError("causal or windowed packed attention needs q_bounds and kv_positions")
    if q.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, q_segment_ids, kv_segment_ids, q_bounds,
                                            kv_positions, sm_scale, causal, window,
                                            logit_softcap)
    softcap = _build.softcap_arg(logit_softcap)
    window = _build.window_arg(window)
    if q.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(f"varlen kernel takes bf16/f16, got {q.dtype}")
    _build.padded_head_dim(d, "varlen", wide=True)
    if hq % hkv or k.shape != v.shape or k.shape[2] != d:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    q, k, v = (_build.rows(name, t, q.dtype) for name, t in (("q", q), ("k", k), ("v", v)))
    if sm_scale is None:
        sm_scale = d ** -0.5

    def meta(x, n):
        if x is None:
            return torch.zeros(n, dtype=torch.int32, device=q.device)
        if x.shape != (n,):
            raise ValueError(f"metadata of shape {tuple(x.shape)} for {n} tokens")
        return x.to(device=q.device, dtype=torch.int32).contiguous()

    q_seg, q_bound = meta(q_segment_ids, tq), meta(q_bounds, tq)
    out = _build.out_rows((hq, tq, d), q.dtype, q.device)
    if tq == 0:
        return out
    kv_meta = kv_metadata(meta(kv_segment_ids, tkv), meta(kv_positions, tkv))
    with torch.cuda.device(q.device):
        VARLEN(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q_seg.data_ptr(),
            q_bound.data_ptr(), kv_meta.data_ptr(), kv_meta.shape[1], hq, hkv, tq, tkv, d,
            *q.stride()[:2], *k.stride()[:2], *v.stride()[:2], float(sm_scale) * LOG2E,
            softcap, int(causal), window, _build.DTYPE_CODES[q.dtype],
        )
    return out


def _seg_metadata(cu: torch.Tensor, total: int) -> tuple[torch.Tensor, torch.Tensor]:
    """cu_seqlens [N + 1] -> (segment_ids [T], positions [T]), int32, on
    cu's device."""
    t = torch.arange(total, dtype=torch.int32, device=cu.device)
    seg = torch.searchsorted(cu[1:].contiguous(), t, right=True).to(torch.int32)
    return seg, t - cu[seg.long()]


def flash_attention_varlen(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cu_seqlens_q: torch.Tensor,
    cu_seqlens_kv: torch.Tensor | None = None,
    sm_scale: float | None = None,
    causal: bool = False,
    window: int | None = None,
    logit_softcap: float | None = None,
    equal_lengths: bool = False,
    max_seqlen: int = 0,
    block_q: int = 0,
    block_kv: int = 0,
    stable: bool | str = True,
) -> torch.Tensor:
    """Varlen attention over packed ragged batches (flash-attn layout).

    Args:
      q: [total_q_tokens, Hq, D], sequences concatenated along axis 0.
      k, v: [total_kv_tokens, Hkv, D].
      cu_seqlens_q / cu_seqlens_kv: [num_seqs + 1] int32 boundaries
        ([0, len_0, len_0 + len_1, ...]); kv defaults to q's.
      causal: per-sequence bottom-right-aligned causality.
      window: per-sequence sliding window (HF semantics).

    Returns [total_q_tokens, Hq, D] in q's dtype (a transposed view).
    """
    tq, tkv = q.shape[0], k.shape[0]
    if cu_seqlens_kv is None:
        cu_seqlens_kv = cu_seqlens_q
    cu_q = cu_seqlens_q.to(device=q.device, dtype=torch.int32)
    cu_kv = cu_seqlens_kv.to(device=q.device, dtype=torch.int32)
    seg_q, pos_q = _seg_metadata(cu_q, tq)
    seg_kv, pos_kv = _seg_metadata(cu_kv, tkv)
    # Bottom-right causal bound of each q token: pos + (kv_len - q_len); a
    # token past the last boundary takes the last sequence's offset (JAX's
    # clamped gather).
    offset = (cu_kv.diff() - cu_q.diff()).to(torch.int32)
    q_bounds = pos_q + offset[seg_q.long().clamp(max=offset.numel() - 1)]
    out = flash_attention_packed(
        q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1), seg_q, seg_kv,
        q_bounds=q_bounds, kv_positions=pos_kv, sm_scale=sm_scale, causal=causal,
        window=window, logit_softcap=logit_softcap,
    )
    return out.transpose(0, 1)
