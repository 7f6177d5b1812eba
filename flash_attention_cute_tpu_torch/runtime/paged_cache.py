"""Paged KV cache: the device-side page pool, the append that fills it, and
the host-side page allocator.

Port of flash_attention_cute_tpu/runtime/paged_cache.py (dense and
quantized pages; the page-prefix copies come with the prefix cache).

Layouts (per-layer views `k_pages[l]` feed ops/paged_attention.py, and
`k_values[l]` / `k_scales[l]` ops/quantized.py):
  k_pages/v_pages:   [L, Hkv, num_pages, page_size, D]
  k_values/v_values: [L, Hkv, num_pages, page_size, D] int8 / float8_e4m3fn
  k_scales/v_scales: [L, Hkv, num_pages, page_size] float32
  page_table:        [B, pages_per_seq] int32 (padding = page 0)
  lengths:           [B] int32

`paged_append_layer` and `paged_append_layer_quantized` write in place (the
JAX versions return new arrays that donation makes in place). On a CUDA
pool they launch the append kernel (csrc/paged_attention.cu) or the
quantize-and-append kernel QA (csrc/quantized.cu); on the CPU they run the
plain versions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flash_attention_cute_tpu_torch.ops import _build
from flash_attention_cute_tpu_torch.ops.paged_attention import append_targets
from flash_attention_cute_tpu_torch.ops.quantized import QuantizedKV, quantize_append

P_, I_, L_ = _build.P, _build.I, _build.L
APPEND = _build.Kernel(
    "paged_append", "paged_attention.cu", "fact_paged_append",
    [P_] * 7 + [I_] * 6 + [L_] * 12 + [P_],
)


@dataclasses.dataclass
class PagedKVState:
    """Device-side paged cache state (the allocator lives on the host)."""

    k_pages: torch.Tensor  # [L, Hkv, P, ps, D]
    v_pages: torch.Tensor
    page_table: torch.Tensor  # [B, pages_per_seq] int32
    lengths: torch.Tensor  # [B] int32

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[2]


def create_paged_state(
    cfg, num_pages: int, page_size: int, batch: int, pages_per_seq: int,
    dtype=None, device="cuda",
) -> PagedKVState:
    """A zeroed pool (as the JAX package's), its rows at
    `_build.row_pitch(head_dim)` (views of head_dim columns), an all-page-0
    table, lengths 0."""
    dtype = dtype or cfg.dtype
    shape = (cfg.num_layers, cfg.num_kv_heads, num_pages, page_size, cfg.head_dim)
    return PagedKVState(
        k_pages=_build.empty_rows(shape, dtype, device, zero=True),
        v_pages=_build.empty_rows(shape, dtype, device, zero=True),
        page_table=torch.zeros((batch, pages_per_seq), dtype=torch.int32, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


@dataclasses.dataclass
class QuantizedPagedKVState:
    """Paged cache with int8 / float8_e4m3fn values and per-token f32 scales:
    half the bytes of a bf16 pool per token, plus 4 bytes of scale per token
    and kv head for each of K and V."""

    k_values: torch.Tensor  # [L, Hkv, P, ps, D]
    k_scales: torch.Tensor  # [L, Hkv, P, ps]
    v_values: torch.Tensor
    v_scales: torch.Tensor
    page_table: torch.Tensor  # [B, pages_per_seq] int32
    lengths: torch.Tensor  # [B] int32

    @property
    def page_size(self) -> int:
        return self.k_values.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k_values.shape[2]

    def layer(self, li: int) -> tuple[QuantizedKV, QuantizedKV]:
        """Layer `li`'s K and V pools (views, written in place)."""
        return (QuantizedKV(self.k_values[li], self.k_scales[li]),
                QuantizedKV(self.v_values[li], self.v_scales[li]))


def create_quantized_paged_state(
    cfg, num_pages: int, page_size: int, batch: int, pages_per_seq: int,
    dtype=torch.int8, device="cuda",
) -> QuantizedPagedKVState:
    """Zero values (rows at `_build.row_pitch(head_dim, 1)`) and unit
    scales (as the JAX package's), an all-page-0 table, lengths 0."""
    shape = (cfg.num_layers, cfg.num_kv_heads, num_pages, page_size, cfg.head_dim)
    return QuantizedPagedKVState(
        k_values=_build.empty_rows(shape, dtype, device, zero=True),
        k_scales=torch.ones(shape[:-1], dtype=torch.float32, device=device),
        v_values=_build.empty_rows(shape, dtype, device, zero=True),
        v_scales=torch.ones(shape[:-1], dtype=torch.float32, device=device),
        page_table=torch.zeros((batch, pages_per_seq), dtype=torch.int32, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def paged_append_layer_quantized(k_slab, v_slab, k_new, v_new, page_table, lengths, active=None):
    """Quantize S new tokens per sequence per token and write values and
    scales into one layer's quantized pools, in place, with the drop rules
    of `paged_append_layer` (inactive rows and positions past the table
    write nothing).

    k_slab/v_slab: (values [Hkv, P, ps, D], scales [Hkv, P, ps]) views of
    the stacked pools; k_new/v_new [B, Hkv, S, D]; page_table [B, pps];
    lengths [B] (before the append); active [B] bool or None. The JAX
    version takes one slab per call; here K and V go in one launch of QA.
    Returns (k_slab, v_slab)."""
    quantize_append(k_new, v_new, QuantizedKV(*k_slab), QuantizedKV(*v_slab), lengths,
                    page_table, active)
    return k_slab, v_slab


def paged_append_layer_plain(k_pages_l, v_pages_l, k_new, v_new, page_table, lengths,
                             active=None):
    """Plain version of the append kernel: a masked scatter (CPU)."""
    ps, s = k_pages_l.shape[2], k_new.shape[2]
    flat_idx, keep = append_targets(page_table, lengths, s, ps, active)
    idx = flat_idx[keep]
    for pages, new in ((k_pages_l, k_new), (v_pages_l, v_new)):
        rows = new.to(pages.dtype).permute(1, 0, 2, 3)[:, keep]  # [Hkv, n, D]
        pages[:, idx // ps, idx % ps] = rows  # no flat view: a pool may be pitched
    return k_pages_l, v_pages_l


def paged_append_layer(k_pages_l, v_pages_l, k_new, v_new, page_table, lengths, active=None):
    """Write S new tokens per sequence into one layer's pool, in place.

    k_pages_l/v_pages_l [Hkv, P, ps, D] (views of the stacked pool), k_new/
    v_new [B, Hkv, S, D] (cast to the pool's dtype), page_table [B, pps],
    lengths [B] (before the append), active [B] bool or None: False rows
    write nothing. Returns (k_pages_l, v_pages_l)."""
    if k_pages_l.device.type == "cpu":
        return paged_append_layer_plain(k_pages_l, v_pages_l, k_new, v_new, page_table,
                                        lengths, active)
    hkv, _, ps, d = k_pages_l.shape
    b, _, s, _ = k_new.shape
    _build.padded_head_dim(d, "paged append", wide=True)
    dt = k_pages_l.dtype
    k_new, v_new = k_new.to(dt), v_new.to(dt)
    if v_pages_l.shape != k_pages_l.shape or v_pages_l.dtype != dt:
        raise ValueError("k and v pools differ")
    if k_new.shape != (b, hkv, s, d) or v_new.shape != k_new.shape:
        raise ValueError(f"bad new rows {tuple(k_new.shape)} {tuple(v_new.shape)}")
    for name, t in (("k_pages", k_pages_l), ("v_pages", v_pages_l)):
        _build.check_cuda_tensor(name, t, dt)  # written in place: never a copy
    k_new, v_new = _build.rows("k_new", k_new, dt), _build.rows("v_new", v_new, dt)
    rows = [("page_table", page_table, (b, page_table.shape[1])), ("lengths", lengths, (b,))]
    if active is not None:
        active = active.to(torch.int32)
        rows.append(("active", active, (b,)))
    for name, t, want in rows:
        if t.device != k_pages_l.device or t.dtype != torch.int32 or t.shape != want \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {list(want)} int32 tensor on the pool's device")
    if b * s == 0:
        return k_pages_l, v_pages_l
    e = k_pages_l.element_size()
    with torch.cuda.device(k_pages_l.device):
        APPEND(
            k_new.data_ptr(), v_new.data_ptr(), k_pages_l.data_ptr(), v_pages_l.data_ptr(),
            lengths.data_ptr(), page_table.data_ptr(),
            None if active is None else active.data_ptr(),
            b, s, hkv, d * e, page_table.shape[1], ps,
            *(x * e for x in k_new.stride()[:3]), *(x * e for x in v_new.stride()[:3]),
            *(x * e for x in k_pages_l.stride()[:3]), *(x * e for x in v_pages_l.stride()[:3]),
        )
    return k_pages_l, v_pages_l


class PageAllocator:
    """Host-side free-list page allocator (scheduler component).

    Page 0 is reserved as the null page: page-table padding points at it so
    out-of-range entries stay valid ids (they are masked in the kernels).
    Every page belongs to one sequence at most: the JAX allocator's shared
    and pinned pages serve its prefix cache, which comes to the port with
    ROADMAP A7b.
    """

    def __init__(self, num_pages: int, page_size: int, pages_per_seq: int):
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.free = list(range(num_pages - 1, 0, -1))  # page 0 reserved
        self.tables: dict[int, list[int]] = {}

    @property
    def num_free(self) -> int:
        return len(self.free)

    def pages_needed(self, cur_len: int, new_tokens: int) -> int:
        have = -(-cur_len // self.page_size) if cur_len else 0
        need = -(-(cur_len + new_tokens) // self.page_size)
        return max(0, need - have)

    def allocate(self, seq_id: int, cur_len: int, new_tokens: int) -> bool:
        """Reserve pages for new_tokens more tokens. False if OOM."""
        n = self.pages_needed(cur_len, new_tokens)
        if n > len(self.free):
            return False
        tbl = self.tables.setdefault(seq_id, [])
        if len(tbl) + n > self.pages_per_seq:
            return False
        for _ in range(n):
            tbl.append(self.free.pop())
        return True

    def release(self, seq_id: int) -> None:
        self.free.extend(reversed(self.tables.pop(seq_id, [])))

    def table_row(self, seq_id: int) -> np.ndarray:
        """Padded page-table row."""
        row = np.zeros((self.pages_per_seq,), np.int32)
        tbl = self.tables.get(seq_id, [])
        row[: len(tbl)] = tbl
        return row
