"""Attention over a quantized KV cache (int8 or float8_e4m3fn values with one
f32 scale per token and kv head): CUDA kernels B7 (decode), B8 (paged
decode), B9 (paged extend) and QA (quantize-and-append), and their plain
versions.

Port of the KV half of flash_attention_cute_tpu/ops/quantized.py. With
per-token scales s_j the kernels never dequantize a K/V row:

    S_ij = (q_i . k_j) * kscale_j        folded into each score
    O_i  = sum_j P_ij * vscale_j * v_j   folded into each probability

  * `flash_attention_decode_quantized`: B7 (csrc/quantized.cu, B8's kernel
    over a contiguous cache, as D1 is B5's) writes split-KV partials over
    one layer of the contiguous cache (values [B, Hkv, C, D], scales
    [B, Hkv, C] of any capacity, or the stacked [L, ...] cache with
    `layer`) for any GQA group (above 32 in chunks of at most 32 q rows,
    a block each: `dispatch.decode_group_chunks`), D2
    (`flash_decode.decode_combine`) merges them. It takes the soft cap.
  * `paged_attention_decode_quantized`: B8 (csrc/quant_paged_decode.cu, the
    kernel of B5 whose consumers widen the values exactly to q's type in
    registers), the same over a pool (values [Hkv, P, ps, D], scales
    [Hkv, P, ps]) through the page table for any GQA group, chunked as
    B7's; D2 merges. It takes the soft cap.
  * `paged_attention_extend_quantized`: B9 (csrc/quant_paged_extend.cu, the
    kernel of B6 whose producer widens the values exactly to q's type),
    chunked prefill over quantized pages with per-row causality
    `col <= q_offset + row`, `col < kv_length`, any GQA group (a block
    runs one q head); it takes the soft cap.
  * `quantize_append`: QA, quantizes new K/V rows per token and writes them
    in place, into the contiguous cache or through the page table.

Each wrapper routes on the device of its tensors: CPU -> plain version,
CUDA -> the kernel; what the kernel does not take raises (values that are
neither int8 nor e4m3, scales that are not f32). B7 - B9 take every GQA
group and a sliding window as D1, B5 and B6 do. All four take every head
dim from 1 to 512 (`_build.padded_head_dim(..., wide=True)`): D 96 runs
in D 128's layout, the TMA boxes reading zeros past the row, which widen
to exact zeros (the TPU kernels pad D to their 128 lanes), and 257-512 in
the wide layouts of 512 (B7 / B8: csrc/paged_decode.cuh's, O's columns
split across the consumer warps; B9: B6's, V widened at its chunk's
columns). B7 - B9 read rows at a
16-byte stride: the port's caches and pools lie at
`_build.row_pitch(D, 1)`, and a q or cache that breaks the rule takes one
padded copy (`_build.rows`, counted by kind); QA reads and writes single
elements and takes rows at any stride. The plain versions dequantize to
fp32 and run the port's `attention_reference` over the gathered rows.
Positions at or past a row's length are never read by the kernels and are
masked out of the plain versions, so they may hold anything, even NaN. The
TPU-only arguments `block_kv`, `pages_per_compute_block`, `interpret` and
`debug` are gone.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from flash_attention_cute_tpu_torch import dispatch
from flash_attention_cute_tpu_torch.ops import _build, flash_decode
from flash_attention_cute_tpu_torch.ops.paged_attention import (
    _check_cuda_call,
    _clamp,
    append_targets,
    decode_plan,
    extend_plan,
    gather_pages,
)
from flash_attention_cute_tpu_torch.ops.reference import attention_reference

INT8_MAX = 127.0
FP8_E4M3_MAX = 448.0
KV_DTYPES = tuple(_build.KV_DTYPE_CODES)
LOG2E = math.log2(math.e)

P, I, L, F = _build.P, _build.I, _build.L, _build.F
QUANT_DECODE = _build.Kernel(
    "quant_decode", "quantized.cu", "fact_quant_decode_partials",
    [P] * 9 + [I] * 9 + [L] * 12 + [F, F, I, I, I, P],
)
QUANT_PAGED_DECODE = _build.Kernel(
    "quant_paged_decode", "quant_paged_decode.cu", "fact_quant_paged_decode_partials",
    [P] * 10 + [I] * 11 + [L] * 12 + [F, F, I, I, I, P],
)
QUANT_PAGED_EXTEND = _build.Kernel(
    "quant_paged_extend", "quant_paged_extend.cu", "fact_quant_paged_extend",
    [P] * 9 + [I] * 9 + [L] * 13 + [F, F, I, I, I, P],
)
QUANT_APPEND = _build.Kernel(
    "quant_append", "quantized.cu", "fact_quant_append",
    [P] * 9 + [I] * 8 + [L] * 13 + [I, I, P],
)


@dataclasses.dataclass
class QuantizedKV:
    """Quantized tensor + per-token scales.

    values: int8 or float8_e4m3fn [..., S, D]
    scales: float32 [..., S] such that original ~= values * scales[..., None]
    """

    values: torch.Tensor
    scales: torch.Tensor


def quantize_kv(x: torch.Tensor, dtype=torch.int8) -> QuantizedKV:
    """Per-token (last-axis) symmetric quantization of [..., S, D]: scale =
    amax / qmax (1 for an all-zero row), values x / scale rounded half to
    even. Bit-identical to the JAX package's on the same fp32 input."""
    if dtype not in KV_DTYPES:
        raise ValueError(f"quantized values are int8 or float8_e4m3fn, got {dtype}")
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # A tensor divisor on amax's device: PyTorch's CUDA division by a
    # Python or CPU scalar multiplies by its reciprocal, which is not the
    # IEEE quotient the JAX package and kernel QA compute.
    qmax = amax.new_tensor(INT8_MAX if dtype == torch.int8 else FP8_E4M3_MAX)
    scales = torch.where(amax == 0.0, 1.0, amax / qmax)
    scaled = xf / scales[..., None]
    values = torch.round(scaled).to(torch.int8) if dtype == torch.int8 else scaled.to(dtype)
    return QuantizedKV(values=values, scales=scales)


def dequantize_kv(q: QuantizedKV, dtype=torch.float32) -> torch.Tensor:
    return (q.values.float() * q.scales[..., None]).to(dtype)


def _layer(kv: QuantizedKV, layer) -> QuantizedKV:
    """One layer of the cache: the 4-D cache itself, or a view of layer
    `layer` of the stacked [L, B, Hkv, C, D] cache (no copy)."""
    if kv.values.ndim == 4:
        if layer is not None:
            raise ValueError("layer is given only with the stacked [L,B,Hkv,C,D] cache")
        return kv
    if kv.values.ndim != 5 or layer is None:
        raise ValueError("a 5-D cache needs a layer index")
    return QuantizedKV(kv.values[layer], kv.scales[layer])


def _gather_dequantized(kv: QuantizedKV, page_table) -> torch.Tensor:
    """One layer's quantized pool -> each row's keys in order, dequantized
    to fp32 [B, Hkv, pps * ps, D] (plain versions only). The values travel
    as bytes, which every device indexes whatever their type."""
    vals = gather_pages(kv.values.view(torch.uint8), page_table).view(kv.values.dtype)
    scales = gather_pages(kv.scales[..., None], page_table)
    return vals.float() * scales


def _check_quantized(name, kv: QuantizedKV, values_dtype=None, read=True) -> QuantizedKV:
    """Refusals shared by the CUDA routes for one quantized cache or pool;
    returns it as a kernel that `read`s it through TMA takes it (values at
    a 16-byte stride, `_build.rows`). QA, which writes single elements,
    takes any stride."""
    vals, scales = kv.values, kv.scales
    if vals.dtype not in KV_DTYPES:
        raise NotImplementedError(
            f"quantized kernels take int8 / float8_e4m3fn {name} values, got {vals.dtype}")
    if read:
        vals = _build.rows(f"{name} values", vals, values_dtype or vals.dtype, "cache")
    else:
        _build.check_cuda_tensor(f"{name} values", vals, values_dtype or vals.dtype,
                                 aligned=False)
    if scales.dtype != torch.float32:
        raise ValueError(f"{name} scales must be float32, got {scales.dtype}")
    if (scales.device != vals.device or scales.shape != vals.shape[:-1]
            or scales.stride(-1) != 1):
        raise ValueError(
            f"{name} scales must be {list(vals.shape[:-1])} with a contiguous last dim on "
            f"the values' device, got {list(scales.shape)} strides {scales.stride()}")
    return QuantizedKV(vals, scales)


# ---- B7: decode over the contiguous cache ----


def flash_attention_decode_quantized_plain(q, k, v, kv_length=None, sm_scale=None, window=None,
                                           logit_softcap=None, num_splits=0, layer=None):
    """Plain version of B7 + D2 on any device: the fp32 reference over the
    dequantized cache (the result does not depend on `num_splits`)."""
    k, v = _layer(k, layer), _layer(v, layer)
    b, cap = q.shape[0], k.values.shape[2]
    if kv_length is None:
        kv_length = torch.full((b,), cap, dtype=torch.int32, device=q.device)
    lens = kv_length.to(device=q.device, dtype=torch.int32).clamp(0, cap)
    return attention_reference(q, dequantize_kv(k), dequantize_kv(v), softmax_scale=sm_scale,
                               kv_length=lens, window=window, logit_softcap=logit_softcap)


def flash_attention_decode_quantized(
    q: torch.Tensor,
    k: QuantizedKV,
    v: QuantizedKV,
    kv_length: torch.Tensor | None = None,
    sm_scale: float | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    num_splits: int = 0,
    layer: int | None = None,
) -> torch.Tensor:
    """Split-KV decode over a quantized cache.

    Args:
      q: [B, Hq, 1, D]
      k, v: QuantizedKV with values [B, Hkv, C, D] (int8 or e4m3) and
        scales [B, Hkv, C] f32, or with `layer` the stacked cache (values
        [L, B, Hkv, C, D], scales [L, B, Hkv, C]; the layer is a view).
      kv_length: [B] int32 live lengths on q's device, clamped to C; None =
        the full cache. A length-0 row outputs exact zeros.
      num_splits: KV-axis splits; 0 picks `dispatch.decode_num_splits`.
      window: sliding window W: only keys [length - W, length) are read.
      logit_softcap: tanh soft cap c of the scaled scores (Gemma2), applied
        after the K scale; None for none.

    Returns [B, Hq, 1, D] in q's dtype.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_decode_quantized_plain(
            q, k, v, kv_length, sm_scale, window, logit_softcap, num_splits, layer)
    softcap = _build.softcap_arg(logit_softcap)
    window = _build.window_arg(window)
    k, v = _layer(k, layer), _layer(v, layer)
    b, hq, sq, d = q.shape
    _, hkv, cap, _ = k.values.shape
    g = hq // hkv
    if q.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(f"quantized decode kernel takes bf16/f16 q, got {q.dtype}")
    _build.padded_head_dim(d, "quantized decode", wide=True)
    if sq != 1 or hq % hkv or k.values.shape != v.values.shape or k.values.shape[0] != b \
            or k.values.shape[3] != d:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.values.shape)} "
                         f"v {tuple(v.values.shape)}")
    q = _build.rows("q", q, q.dtype)
    k = _check_quantized("k", k)
    v = _check_quantized("v", v, k.values.dtype)
    if kv_length is None:
        kv_length = torch.full((b,), cap, dtype=torch.int32, device=q.device)
    if (kv_length.device != q.device or kv_length.dtype != torch.int32
            or kv_length.shape != (b,) or not kv_length.is_contiguous()):
        raise ValueError("kv_length must be a contiguous [B] int32 tensor on q's device")
    splits = num_splits if num_splits > 0 else dispatch.decode_num_splits(b, hkv, cap, d, g)
    if not (0 < splits <= cap):
        raise ValueError(f"num_splits {splits} outside 1..{cap}")

    acc = torch.empty((b, hkv, splits, g, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, splits, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        QUANT_DECODE(
            q.data_ptr(), k.values.data_ptr(), v.values.data_ptr(), k.scales.data_ptr(),
            v.scales.data_ptr(), kv_length.data_ptr(), acc.data_ptr(), m.data_ptr(),
            l.data_ptr(), b, hkv, g, *dispatch.decode_group_chunks(g), cap, d, splits,
            -(-cap // splits),
            q.stride(0), q.stride(1), *k.values.stride()[:3], *v.values.stride()[:3],
            *k.scales.stride()[:2], *v.scales.stride()[:2],
            float(sm_scale) * LOG2E, softcap, window, _build.DTYPE_CODES[q.dtype],
            _build.KV_DTYPE_CODES[k.values.dtype],
        )
    return flash_decode.decode_combine(acc, m, l, q.dtype)


# ---- B8 / B9: decode and extend over quantized pages ----


def paged_attention_decode_quantized_plain(q, k_pages, v_pages, lengths, page_table,
                                           sm_scale=None, window=None, logit_softcap=None):
    """Plain version of B8 + D2 on any device: the fp32 reference over the
    gathered, dequantized pages."""
    lens = _clamp(lengths, page_table, k_pages.values.shape[2]).to(q.device)
    return attention_reference(
        q, _gather_dequantized(k_pages, page_table), _gather_dequantized(v_pages, page_table),
        softmax_scale=sm_scale, kv_length=lens, window=window, logit_softcap=logit_softcap,
    )


def paged_attention_extend_quantized_plain(q, k_pages, v_pages, q_offset, kv_length, page_table,
                                           sm_scale=None, window=None, logit_softcap=None):
    """Plain version of B9 on any device: the fp32 reference over the
    gathered, dequantized pages with per-row offsets."""
    lens = _clamp(kv_length, page_table, k_pages.values.shape[2]).to(q.device)
    return attention_reference(
        q, _gather_dequantized(k_pages, page_table), _gather_dequantized(v_pages, page_table),
        softmax_scale=sm_scale, causal=True, kv_length=lens,
        q_offset=q_offset.to(device=q.device, dtype=torch.int32), window=window,
        logit_softcap=logit_softcap,
    )


def extend_kernel_report() -> str:
    """Registers, spill bytes and shared memory of every B9 instantiation,
    as the card's runtime reports them."""
    return _build.runtime_report(QUANT_PAGED_EXTEND.source, "fact_quant_paged_extend_report")


def decode_kernel_report() -> str:
    """The same of every B8 instantiation."""
    return _build.runtime_report(QUANT_PAGED_DECODE.source, "fact_quant_paged_decode_report")


def contiguous_decode_kernel_report() -> str:
    """The same of every B7 instantiation."""
    return _build.runtime_report(QUANT_DECODE.source, "fact_quant_decode_report")


def _check_paged(name, q, k_pages, v_pages, page_table, row_tensors, window):
    """The refusals of B8 / B9: those of B5 / B6, the quantized pools', and
    scales each page part of which one 16-byte aligned bulk copy brings.
    Returns the window, and q and the pools as the kernels read them."""
    window, q, kv, vv = _check_cuda_call(name, q, k_pages.values, v_pages.values, page_table,
                                         row_tensors, window, k_pages.values.dtype)
    k_pages = _check_quantized("k_pages", QuantizedKV(kv, k_pages.scales))
    v_pages = _check_quantized("v_pages", QuantizedKV(vv, v_pages.scales), kv.dtype)
    for pname, kv in (("k_pages", k_pages), ("v_pages", v_pages)):
        sc = kv.scales
        if sc.data_ptr() % 16 or sc.stride(0) % 4 or sc.stride(1) % 4:
            raise ValueError(f"{pname} scales need a 16-byte aligned base and head and page "
                             f"strides, got {sc.data_ptr():#x} strides {sc.stride()}")
    return window, q, k_pages, v_pages


def paged_attention_decode_quantized(
    q: torch.Tensor,
    k_pages: QuantizedKV,
    v_pages: QuantizedKV,
    lengths: torch.Tensor,
    page_table: torch.Tensor,
    sm_scale: float | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """Single-token decode over a quantized paged KV cache.

    Args:
      q: [B, Hq, 1, D]
      k_pages, v_pages: QuantizedKV with values [Hkv, P, ps, D] (int8 or
        e4m3) and scales [Hkv, P, ps] f32 (one layer's views).
      lengths: [B] int32 valid token counts, clamped to pages_per_seq * ps
        (0 -> an exact zero row).
      page_table: [B, pages_per_seq] int32 physical page ids.
      window: sliding window W: only keys [length - W, length) are read.
      logit_softcap: tanh soft cap c of the scaled scores (Gemma2), applied
        after the K scale; None for none.

    Returns [B, Hq, 1, D] in q's dtype.
    """
    b, hq, sq, d = q.shape
    if sq != 1:
        raise ValueError(f"decode takes one query row, got {sq}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    if q.device.type == "cpu":
        return paged_attention_decode_quantized_plain(q, k_pages, v_pages, lengths, page_table,
                                                      sm_scale, window, logit_softcap)
    softcap = _build.softcap_arg(logit_softcap)
    window, q, k_pages, v_pages = _check_paged(
        "quantized paged decode", q, k_pages, v_pages, page_table, [("lengths", lengths)], window)
    hkv, num_pages, ps, _ = k_pages.values.shape
    pps = page_table.shape[1]
    g = hq // hkv
    splits = dispatch.decode_num_splits(b, hkv, pps * ps, d, g)
    acc = torch.empty((b, hkv, splits, g, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, splits, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        QUANT_PAGED_DECODE(
            q.data_ptr(), k_pages.values.data_ptr(), v_pages.values.data_ptr(),
            k_pages.scales.data_ptr(), v_pages.scales.data_ptr(), lengths.data_ptr(),
            page_table.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            b, hkv, g, *dispatch.decode_group_chunks(g), d, splits, pps, ps, num_pages,
            decode_plan(d, ps)[1], q.stride(0), q.stride(1), *k_pages.values.stride()[:3],
            *v_pages.values.stride()[:3], *k_pages.scales.stride()[:2],
            *v_pages.scales.stride()[:2], float(sm_scale) * LOG2E, softcap, window,
            _build.DTYPE_CODES[q.dtype], _build.KV_DTYPE_CODES[k_pages.values.dtype],
        )
    return flash_decode.decode_combine(acc, m, l, q.dtype)


def paged_attention_extend_quantized(
    q: torch.Tensor,
    k_pages: QuantizedKV,
    v_pages: QuantizedKV,
    q_offset: torch.Tensor,
    kv_length: torch.Tensor,
    page_table: torch.Tensor,
    sm_scale: float | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    return_clamps: bool = False,
):
    """Chunked prefill over a quantized paged cache.

    Args:
      q: [B, Hq, S, D], the chunk's queries (global rows q_offset .. +S); any
        strides with the head dim contiguous.
      k_pages, v_pages: QuantizedKV (values [Hkv, P, ps, D], scales
        [Hkv, P, ps]) with the chunk's own K/V already quantized and
        written at positions [q_offset, q_offset + S).
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
        out = paged_attention_extend_quantized_plain(q, k_pages, v_pages, q_offset, kv_length,
                                                     page_table, sm_scale, window, logit_softcap)
        return (out, 0) if return_clamps else out
    softcap = _build.softcap_arg(logit_softcap)
    window, q, k_pages, v_pages = _check_paged(
        "quantized paged extend", q, k_pages, v_pages, page_table,
        [("q_offset", q_offset), ("kv_length", kv_length)], window)
    hkv, num_pages, ps, _ = k_pages.values.shape
    out = _build.out_rows((b, hq, sq, d), q.dtype, q.device)
    if out.numel():
        with torch.cuda.device(q.device):
            QUANT_PAGED_EXTEND(
                q.data_ptr(), k_pages.values.data_ptr(), v_pages.values.data_ptr(),
                k_pages.scales.data_ptr(), v_pages.scales.data_ptr(), out.data_ptr(),
                q_offset.data_ptr(), kv_length.data_ptr(), page_table.data_ptr(),
                b, hq, hkv, sq, d, page_table.shape[1], ps, num_pages, extend_plan(d, ps)[1],
                *q.stride()[:3], *k_pages.values.stride()[:3], *v_pages.values.stride()[:3],
                *k_pages.scales.stride()[:2], *v_pages.scales.stride()[:2],
                float(sm_scale) * LOG2E, softcap, window, _build.DTYPE_CODES[q.dtype],
                _build.KV_DTYPE_CODES[k_pages.values.dtype],
            )
    return (out, 0) if return_clamps else out


# ---- QA: quantize-and-append ----


def quantize_append_plain(k_new, v_new, k_cache: QuantizedKV, v_cache: QuantizedKV, lengths,
                          page_table=None, active=None):
    """Plain version of QA: `quantize_kv` of the new rows, then an indexed
    write of values and scales (a masked scatter through the table when
    `page_table` is given). The values are written as bytes."""
    b, hkv, s, _ = k_new.shape
    dev = lengths.device
    pos = lengths.long()[:, None] + torch.arange(s, device=dev)  # [B, S]
    if page_table is None:
        if active is not None:
            raise ValueError("active rows are taken with a page table only")
        rows = torch.arange(b, device=dev)[:, None, None]
        heads = torch.arange(hkv, device=dev)[None, :, None]
        index = (rows, heads, pos[:, None, :])
    else:
        flat_idx, keep = append_targets(page_table, lengths, s, k_cache.values.shape[2], active)
        idx = flat_idx[keep]
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        nq = quantize_kv(new, cache.values.dtype)
        vals, pool = nq.values.view(torch.uint8), cache.values.view(torch.uint8)
        if page_table is None:
            pool[index] = vals
            cache.scales[index] = nq.scales
        else:
            ps = pool.shape[2]  # pages and slots apart: a pitched pool has no flat view
            pool[:, idx // ps, idx % ps] = vals.permute(1, 0, 2, 3)[:, keep]
            cache.scales[:, idx // ps, idx % ps] = nq.scales.permute(1, 0, 2)[:, keep]


def quantize_append(
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_cache: QuantizedKV,
    v_cache: QuantizedKV,
    lengths: torch.Tensor,
    page_table: torch.Tensor | None = None,
    active: torch.Tensor | None = None,
) -> None:
    """Quantize S new K/V rows per batch row (per token, as `quantize_kv`)
    and write values and scales in place at positions lengths[b] + s.

    Args:
      k_new, v_new: [B, Hkv, S, D] bf16/f16 (any strides with the head dim
        contiguous; the plain version takes any float dtype).
      k_cache, v_cache: one layer's QuantizedKV: without `page_table` the
        contiguous cache (values [B, Hkv, C, D], scales [B, Hkv, C]; caller
        contract lengths + S <= C), with it a pool (values [Hkv, P, ps, D],
        scales [Hkv, P, ps]). K and V share shapes and strides.
      lengths: [B] int32, positions before the append.
      page_table: [B, pages_per_seq] int32, or None.
      active: [B] bool or None (paged only): False rows write nothing, and
        positions past the table are dropped (JAX's `mode="drop"`).
    """
    if k_cache.values.device.type == "cpu":
        quantize_append_plain(k_new, v_new, k_cache, v_cache, lengths, page_table, active)
        return
    paged = page_table is not None
    b, hkv, s, d = k_new.shape
    kv_dtype = k_cache.values.dtype
    if k_new.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(f"quantize-append kernel takes bf16/f16 rows, got {k_new.dtype}")
    _build.padded_head_dim(d, "quantize-append", wide=True)
    if v_new.shape != k_new.shape or v_new.dtype != k_new.dtype:
        raise ValueError(f"bad new rows {tuple(k_new.shape)} {tuple(v_new.shape)}")
    _check_quantized("k_cache", k_cache, read=False)
    _check_quantized("v_cache", v_cache, kv_dtype, read=False)
    if (v_cache.values.shape != k_cache.values.shape
            or v_cache.values.stride() != k_cache.values.stride()
            or v_cache.scales.stride() != k_cache.scales.stride()):
        raise ValueError("the K and V caches must share shapes and strides")
    want = (hkv, d) if paged else (b, hkv, d)
    have = (k_cache.values.shape[0], k_cache.values.shape[3]) if paged else \
        (k_cache.values.shape[0], k_cache.values.shape[1], k_cache.values.shape[3])
    if have != want:
        raise ValueError(f"new rows {tuple(k_new.shape)} do not fit the cache "
                         f"{tuple(k_cache.values.shape)}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        _build.check_cuda_tensor(name, t, k_new.dtype, aligned=False)
    rows = [("lengths", lengths, (b,))]
    if paged:
        rows.append(("page_table", page_table, (b, page_table.shape[1])))
    if active is not None:
        if not paged:
            raise ValueError("active rows are taken with a page table only")
        active = active.to(torch.int32)
        rows.append(("active", active, (b,)))
    dev = k_cache.values.device
    for name, t, shape in rows:
        if t.device != dev or t.dtype != torch.int32 or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {list(shape)} int32 tensor on the "
                             "cache's device")
    if b * s == 0:
        return
    cs, ss = k_cache.values.stride(), k_cache.scales.stride()
    if paged:
        c_strides = (0, cs[0], cs[2], cs[1])  # sb, sh, ss, sp
        s_strides = (0, ss[0], ss[1])  # sb, sh, sp
        cap, pps, ps = 0, page_table.shape[1], k_cache.values.shape[2]
    else:
        c_strides = (cs[0], cs[1], cs[2], 0)
        s_strides = (ss[0], ss[1], 0)
        cap, pps, ps = k_cache.values.shape[2], 0, 0
    with torch.cuda.device(dev):
        QUANT_APPEND(
            k_new.data_ptr(), v_new.data_ptr(), k_cache.values.data_ptr(),
            v_cache.values.data_ptr(), k_cache.scales.data_ptr(), v_cache.scales.data_ptr(),
            lengths.data_ptr(), page_table.data_ptr() if paged else None,
            None if active is None else active.data_ptr(),
            int(paged), b, s, hkv, d, cap, pps, ps,
            *k_new.stride()[:3], *v_new.stride()[:3], *c_strides, *s_strides,
            _build.DTYPE_CODES[k_new.dtype], _build.KV_DTYPE_CODES[kv_dtype],
        )
