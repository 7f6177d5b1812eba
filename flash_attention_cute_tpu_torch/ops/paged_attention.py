"""Attention over a paged KV cache: CUDA kernels B5 (decode) and B6 (extend)
and their plain versions.

Port of flash_attention_cute_tpu/ops/paged_attention.py. One layer's pool is
`[Hkv, P, ps, D]` (a view `k_pages[layer]` of the stacked `[L, Hkv, P, ps,
D]` pool); key n of batch row b sits at page `page_table[b, n // ps]`, row
`n % ps`. Lengths are clamped to `pages_per_seq * ps`.

  * `paged_attention_decode`: B5 (csrc/paged_attention.cu, the kernel of
    csrc/paged_decode.cuh shared with B8: a TMA ring of pages feeding
    tensor-core consumers) writes split-KV partials of any GQA group (above
    32 in chunks of at most 32 q rows, a block each:
    `dispatch.decode_group_chunks`), D2 (`flash_decode.decode_combine`)
    merges them. The splits come from
    shapes alone (`dispatch.decode_num_splits`). With a sliding window W
    only keys [length - W, length) are read.
  * `paged_attention_extend`: B6, chunked prefill with per-row global
    causality `col <= q_offset + row` and `col < kv_length` (and with a
    window `col > q_offset + row - W`); kv_length 0 marks an inactive row,
    which outputs exact zeros. The kernel (csrc/paged_extend.cuh, shared with
    B9) is wgmma fed by TMA copies of single pages, in the parts
    `extend_plan` picks; a block runs one q head, so any GQA group runs
    (each q head's block reads its kv head's pages itself).

B5 and B6 take the tanh soft cap (Gemma2) and every head dim from 1 to
512 (`_build.padded_head_dim(..., wide=True)`: D 96 runs in D 128's
layout, its columns past 96 zeros, and 257-512 in the wide layouts of 512,
csrc/paged_decode.cuh's and csrc/attention_wgmma.cuh's), and so does the
append. Rows reach them at a 16-byte stride: the port's pools lie
at `_build.row_pitch`, and a q or pool that breaks the rule takes one
padded copy (`_build.rows`, counted by kind); B6's output lies at
`_build.row_pitch(D)`.
Each wrapper routes on the device of `q`: CPU -> plain version, CUDA -> the
kernel; what the kernel does not take raises (a pool whose dtype differs
from q's). Positions at or past a row's length are never read
by the kernels and are masked out of the plain versions, so unused pages may
hold anything, even NaN. The TPU-only arguments `pages_per_compute_block`,
`interpret` and `debug` are gone.
"""

from __future__ import annotations

import math

import torch

from flash_attention_cute_tpu_torch import dispatch
from flash_attention_cute_tpu_torch.ops import _build, flash_decode
from flash_attention_cute_tpu_torch.ops.reference import attention_reference

LOG2E = math.log2(math.e)

P, I, L, F = _build.P, _build.I, _build.L, _build.F
PAGED_DECODE = _build.Kernel(
    "paged_decode", "paged_attention.cu", "fact_paged_decode_partials",
    [P] * 8 + [I] * 11 + [L] * 8 + [F, F, I, I, P],
)
PAGED_EXTEND = _build.Kernel(
    "paged_extend", "paged_attention.cu", "fact_paged_extend",
    [P] * 7 + [I] * 9 + [L] * 9 + [F, F, I, I, P],
)


def extend_plan(head_dim: int, page_size: int) -> tuple[int, int]:
    """(keys of a tile, keys of one copy) of the paged extend kernels B6 /
    B9: tiles of 128 keys (64 in D 256's layout, every head dim above 128,
    where O takes twice the registers; 32 in B6's wide layout of 512, every
    head dim above 256, where a K tile of 64 keys would take 64 KB), each
    copied by TMA in parts of `gcd(tile, page_size)` keys, a whole page
    where pages are no wider than the tile. Parts start on a tile's and a
    page's boundaries alike, and page_size % 8 == 0 keeps each one at least
    eight 128-byte rows (the 1 KB the swizzle's pattern spans)."""
    tile = 32 if head_dim > 256 else 64 if head_dim > 128 else 128
    return tile, math.gcd(tile, page_size)


def decode_plan(head_dim: int, page_size: int) -> tuple[int, int]:
    """(keys of a tile, keys of one copy) of the paged decodes B5 / B8: the
    tile of `dispatch.decode_tile`, copied by TMA in parts of
    `gcd(tile, page_size)` keys that start on a tile's and a page's
    boundaries alike (at least eight rows: page_size % 8 == 0)."""
    tile = dispatch.decode_tile(head_dim)
    return tile, math.gcd(tile, page_size)


def kernel_report() -> str:
    """Registers, spill bytes and shared memory of every B6 instantiation,
    as the card's runtime reports them."""
    return _build.runtime_report(PAGED_EXTEND.source, "fact_paged_extend_report")


def decode_kernel_report() -> str:
    """The same of every B5 instantiation."""
    return _build.runtime_report(PAGED_DECODE.source, "fact_paged_decode_report")


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """One layer's pool [Hkv, P, ps, D] -> each row's keys in order,
    [B, Hkv, pages_per_seq * ps, D] (a copy; plain versions only)."""
    hkv, _, ps, d = pages.shape
    b, pps = page_table.shape
    g = pages[:, page_table.long()]  # [Hkv, B, pps, ps, D]
    return g.permute(1, 0, 2, 3, 4).reshape(b, hkv, pps * ps, d)


def append_targets(page_table, lengths, s, page_size, active=None):
    """Flat pool rows [B, S] (page * ps + offset) of an append of S tokens
    at each row's length, and the [B, S] mask of the rows that write: rows
    of inactive batch rows and positions past the table write nothing (the
    `mode="drop"` of the JAX scatter, `_scatter_indices`)."""
    pos = lengths.long()[:, None] + torch.arange(s, device=lengths.device)
    slot = pos // page_size
    pps = page_table.shape[1]
    page = torch.gather(page_table.long(), 1, slot.clamp(max=pps - 1))
    keep = slot < pps
    if active is not None:
        keep &= active.to(torch.bool)[:, None]
    return page * page_size + pos % page_size, keep


def _clamp(lengths: torch.Tensor, page_table: torch.Tensor, page_size: int) -> torch.Tensor:
    return lengths.to(torch.int32).clamp(0, page_table.shape[1] * page_size)


def paged_attention_decode_plain(q, k_pages, v_pages, lengths, page_table, sm_scale=None,
                                 window=None, logit_softcap=None):
    """Plain version of B5 + D2 on any device: the fp32 reference over the
    gathered pages."""
    lens = _clamp(lengths, page_table, k_pages.shape[2]).to(q.device)
    return attention_reference(
        q, gather_pages(k_pages, page_table), gather_pages(v_pages, page_table),
        softmax_scale=sm_scale, kv_length=lens, window=window, logit_softcap=logit_softcap,
    )


def paged_attention_extend_plain(q, k_pages, v_pages, q_offset, kv_length, page_table,
                                 sm_scale=None, window=None, logit_softcap=None):
    """Plain version of B6 on any device: the fp32 reference over the
    gathered pages with per-row offsets."""
    lens = _clamp(kv_length, page_table, k_pages.shape[2]).to(q.device)
    return attention_reference(
        q, gather_pages(k_pages, page_table), gather_pages(v_pages, page_table),
        softmax_scale=sm_scale, causal=True, kv_length=lens,
        q_offset=q_offset.to(device=q.device, dtype=torch.int32), window=window,
        logit_softcap=logit_softcap,
    )


def _check_cuda_call(name, q, k_pages, v_pages, page_table, row_tensors, window,
                     pool_dtype=None):
    """Shared refusals of the CUDA routes of B5, B6, B8 and B9; the pools
    must be `pool_dtype` (default q's dtype), head dims those of
    `_build.padded_head_dim`'s rule with its wide layout (up to 512), Hq a
    multiple of Hkv (any group).
    Returns the window as the kernels take it, and q, k_pages, v_pages as
    they read them (`_build.rows`)."""
    window = _build.window_arg(window)
    b, hq, _, d = q.shape
    hkv = k_pages.shape[0]
    if q.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(f"{name} kernel takes bf16/f16, got {q.dtype}")
    _build.padded_head_dim(d, name, wide=True)
    if hq % hkv:
        raise ValueError(f"{name}: num q heads {hq} must be a multiple of kv heads {hkv}")
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != d or k_pages.ndim != 4:
        raise ValueError(f"bad pools k {tuple(k_pages.shape)} v {tuple(v_pages.shape)}")
    if k_pages.shape[2] % 8:
        raise ValueError(f"page_size must be a multiple of 8, got {k_pages.shape[2]}")
    q = _build.rows("q", q, q.dtype)
    # The pool is never cast here: a cast would copy the layer's whole pool.
    k_pages, v_pages = (_build.rows(n, t, pool_dtype or q.dtype, "cache")
                        for n, t in (("k_pages", k_pages), ("v_pages", v_pages)))
    for n, t in (("page_table", page_table), *row_tensors):
        want = (b, page_table.shape[1]) if n == "page_table" else (b,)
        if t.device != q.device or t.dtype != torch.int32 or t.shape != want or not t.is_contiguous():
            raise ValueError(f"{n} must be a contiguous {list(want)} int32 tensor on q's device")
    return window, q, k_pages, v_pages


def paged_attention_decode(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_table: torch.Tensor,
    sm_scale: float | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """Single-token decode over a paged KV cache.

    Args:
      q: [B, Hq, 1, D]
      k_pages, v_pages: one layer's pool [Hkv, P, ps, D]; on CUDA in q's dtype.
      lengths: [B] int32 valid token counts (0 -> an exact zero row).
      page_table: [B, pages_per_seq] int32 physical page ids.
      window: sliding window W: only keys [length - W, length) are read.
      logit_softcap: tanh soft cap c of the scaled scores (Gemma2); None
        for none.

    Returns [B, Hq, 1, D] in q's dtype.
    """
    b, hq, sq, d = q.shape
    if sq != 1:
        raise ValueError(f"decode takes one query row, got {sq}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    if q.device.type == "cpu":
        return paged_attention_decode_plain(q, k_pages, v_pages, lengths, page_table,
                                            sm_scale, window, logit_softcap)
    softcap = _build.softcap_arg(logit_softcap)
    window, q, k_pages, v_pages = _check_cuda_call(
        "paged decode", q, k_pages, v_pages, page_table, [("lengths", lengths)], window)
    hkv, num_pages, ps, _ = k_pages.shape
    pps = page_table.shape[1]
    g = hq // hkv
    splits = dispatch.decode_num_splits(b, hkv, pps * ps, d, g)
    acc = torch.empty((b, hkv, splits, g, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, splits, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        PAGED_DECODE(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
            page_table.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            b, hkv, g, *dispatch.decode_group_chunks(g), d, splits, pps, ps, num_pages,
            decode_plan(d, ps)[1],
            q.stride(0), q.stride(1), *k_pages.stride()[:3], *v_pages.stride()[:3],
            float(sm_scale) * LOG2E, softcap, window, _build.DTYPE_CODES[q.dtype],
        )
    return flash_decode.decode_combine(acc, m, l, q.dtype)


def paged_attention_extend(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    q_offset: torch.Tensor,
    kv_length: torch.Tensor,
    page_table: torch.Tensor,
    sm_scale: float | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    return_clamps: bool = False,
):
    """Chunked prefill over a paged cache.

    Args:
      q: [B, Hq, S, D], the chunk's queries (global rows q_offset .. +S); any
        strides with the head dim contiguous.
      k_pages, v_pages: one layer's pool [Hkv, P, ps, D] with the chunk's K/V
        already written at positions [q_offset, q_offset + S).
      q_offset: [B] int32; kv_length: [B] int32 = q_offset + S for active
        rows, 0 for inactive rows (their output is zeros).
      page_table: [B, pages_per_seq] int32.
      window: sliding window W: row r also masks keys n <= q_offset + r - W.
      logit_softcap: tanh soft cap c of the scaled scores (Gemma2); None
        for none.
      return_clamps: also return the softmax clamp count, which is 0: the
        port's softmax is exact (the TPU kernel's lazy max is not copied).

    Returns [B, Hq, S, D] in q's dtype (with return_clamps, (out, 0)).
    """
    b, hq, sq, d = q.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    if q.device.type == "cpu":
        out = paged_attention_extend_plain(q, k_pages, v_pages, q_offset, kv_length,
                                           page_table, sm_scale, window, logit_softcap)
        return (out, 0) if return_clamps else out
    softcap = _build.softcap_arg(logit_softcap)
    window, q, k_pages, v_pages = _check_cuda_call(
        "paged extend", q, k_pages, v_pages, page_table,
        [("q_offset", q_offset), ("kv_length", kv_length)], window)
    hkv, num_pages, ps, _ = k_pages.shape
    out = _build.out_rows((b, hq, sq, d), q.dtype, q.device)
    if out.numel():
        with torch.cuda.device(q.device):
            PAGED_EXTEND(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(),
                q_offset.data_ptr(), kv_length.data_ptr(), page_table.data_ptr(),
                b, hq, hkv, sq, d, page_table.shape[1], ps, num_pages, extend_plan(d, ps)[1],
                *q.stride()[:3], *k_pages.stride()[:3], *v_pages.stride()[:3],
                float(sm_scale) * LOG2E, softcap, window, _build.DTYPE_CODES[q.dtype],
            )
    return (out, 0) if return_clamps else out
