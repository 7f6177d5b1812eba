"""Weight-only quantized matrix products: CUDA kernels B10 (int8) and B11
(int4), and their plain versions.

Port of flash_attention_cute_tpu/ops/quantized_matmul.py. Weights are
stored [K, N] (the package's [in, out] layout) in one of two formats, kept
exactly as the JAX package defines them so that quantized parameters cross
between the packages unchanged:

  * `QuantizedWeight`, int8: values [..., K_pad, N_pad] int8, one f32 scale
    per output column, scales [..., N_pad]. Symmetric absmax: scale =
    amax / 127 (1 for an all-zero column), values round(w / scale) half to
    even. K_pad = round_up(K, min(512, round_up(K, 128))), N_pad =
    round_up(N, min(1024, round_up(N, 128))).
  * `QuantizedWeight4`, int4: one f32 scale per (128-row group, column),
    scales [..., K_pad / 128, N_pad], scale = amax / 7, values
    clip(round(w / scale), -8, 7). Stored biased (u = q + 8) two to a byte,
    values [..., K_pad / 2, N_pad] int8, packed in blocks of bk = min(512,
    K_pad) rows: packed row r of block b holds row b*bk + r in its low
    nibble and row b*bk + bk/2 + r in its high nibble. K_pad =
    round_up(K, min(512, round_up(K, 256))), N_pad = round_up(N, min(2048,
    round_up(N, 128))).

Padded rows and columns hold the value 0 under a unit scale, so the padding
is exact. A layer-stacked leaf carries a leading [L] axis on both fields;
`w[li]` takes one layer (a view), which is how the model's layer loop
slices it.

`quantized_matmul(x, w)` routes on x's device only: a CPU tensor takes the
plain version, a CUDA tensor kernel B10 or B11 (csrc/quantized_matmul.cu),
and what they do not take raises (fp32 activations, stacked weights). On
the card `qmm_plan` picks one of the kernels' two designs and the number of
K splits from the shapes alone: the decode design (mma.sync over a
cp.async ring, K split to about one block per SM) for at most
`DECODE_MAX_T` rows of x, or for x rows that TMA cannot take (a base or row
stride not 16-byte aligned); the prefill design (wgmma fed by TMA) for the
rest. The choice is a documented dispatch between two hand-written kernels,
never a fallback. The
`impl` field is carried so that trees cross between the packages unchanged;
the port reads it nowhere (it selects a product form for a tensor-parallel
mesh in the JAX package, and the port has no meshes yet).

Quantization is bit-identical to the JAX package's. A single [K, N] weight
gets scale = amax / qmax, an IEEE quotient; a stacked one gets amax times
the fp32 reciprocal of qmax, because that is what XLA compiles the JAX
package's per-layer `lax.map` body into (the two differ in the last ulp of
a few scales). Both then divide w by the scales. Divisions are by device
tensors, never by a Python scalar: PyTorch's CUDA division by a scalar
multiplies by its reciprocal, which would move some values on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from flash_attention_cute_tpu_torch.ops import _build

LANES = 128
BLOCK_K = 512    # int8 K padding cap, and the int4 pack block
BLOCK_N = 2048   # int4 N padding cap
BLOCK_N8 = 1024  # int8 N padding cap
GROUP4 = 128     # K rows per int4 scale group
ACT_DTYPES = tuple(_build.DTYPE_CODES)

P, I, L = _build.P, _build.I, _build.L
_ARGS = [P] * 5 + [I] * 5 + [L] + [I] * 5 + [P]
QMM8 = _build.Kernel("quantized_matmul", "quantized_matmul.cu", "fact_qmm_int8", _ARGS)
QMM4 = _build.Kernel("quantized_matmul_int4", "quantized_matmul.cu", "fact_qmm_int4", _ARGS)

# The kernels' tiling (csrc/quantized_matmul.cu): weight tiles of TILE_ROWS
# stored rows (int8: K rows; int4: packed rows, two K rows a byte) by
# TILE_N columns; the decode design takes up to 16 rows of x per block, the
# prefill design 128.
TILE_ROWS, TILE_N = 64, 128
DECODE_ROWS, PREFILL_ROWS = 16, 128
DECODE_MAX_T = 16  # x rows up to which the decode design runs (the measured crossover)
SMS = 132          # streaming multiprocessors of an H100 SXM
ROUTES = ("decode", "prefill")


@dataclasses.dataclass(frozen=True)
class QmmPlan:
    """How B10 / B11 run one product: the design, and K cut into `splits`
    ranges of whole units (`unit` tiles each: one for the int8 prefill; a
    pair for int4, so that a group's two 64-row halves stay in one split,
    and for the decode design, whose stages hold two tiles) over a grid of
    `blocks` = column tiles (of `tile_n` columns) x row tiles x splits."""

    route: str
    splits: int
    tiles: int
    unit: int
    col_tiles: int
    row_tiles: int
    tile_n: int = TILE_N

    @property
    def blocks(self) -> int:
        return self.col_tiles * self.row_tiles * self.splits

    def split_tiles(self, s: int) -> tuple[int, int]:
        """Tiles [begin, end) of split s (the kernels' `split_range`)."""
        units = self.tiles // self.unit
        return (s * units // self.splits * self.unit, (s + 1) * units // self.splits * self.unit)


def qmm_plan(t: int, k: int, n: int, k_pad: int, n_pad: int, int4: bool,
             x_aligned: bool, route: str | None = None, splits: int | None = None) -> QmmPlan:
    """The design and K splits of one product of x [t, k] and a weight of
    padded shape k_pad x n_pad. `x_aligned`: x's base and row stride are
    16-byte aligned, which TMA needs. `route` and `splits` force a design
    and a split count (for comparing them); the prefill design still needs
    aligned x, and splits stay within 1 .. the units of K.

    int8 prefill walks ceil(k / 64) tiles (rows past K are zero and
    skipped), int8 decode the pairs of tiles that cover K (its stages), int4
    all k_pad / 128 tiles in pairs (the block-local packing interleaves
    halves). Decode: K is split until the grid holds about one block per SM
    (splits = SMS / tiles of y, rounded), never finer than one unit a
    split. On the H100 that beat two waves at every Llama-3-8B decode shape:
    a second resident block per SM adds no bandwidth there and costs its
    share of the partials and a tail (PERF.md). Prefill: one block an SM; K
    is split only when the tiles of y cover fewer than half the SMs (each
    split adds an fp32 round trip of y through the workspace)."""
    if route is None:
        route = "prefill" if t > DECODE_MAX_T and x_aligned else "decode"
    if route not in ROUTES or (route == "prefill" and not x_aligned):
        raise ValueError(f"no {route!r} route for x rows aligned={x_aligned}")
    if int4:
        tiles, unit = k_pad // 2 // TILE_ROWS, 2
    elif route == "decode":  # its stages are pairs of tiles
        tiles, unit = 2 * -(-k // (2 * TILE_ROWS)), 2
    else:
        tiles, unit = -(-k // TILE_ROWS), 1
    units = tiles // unit
    # The decode design takes 256-column blocks (one tile a stage) where
    # 128-column blocks would already put more than one block on an SM.
    tile_n = 2 * TILE_N if route == "decode" and -(-n // TILE_N) > SMS else TILE_N
    col_tiles = -(-n // tile_n)
    row_tiles = -(-t // (DECODE_ROWS if route == "decode" else PREFILL_ROWS))
    base = col_tiles * row_tiles
    if splits is not None:
        want = splits
        if not 1 <= splits <= units:
            raise ValueError(f"splits must be in 1 .. {units}, got {splits}")
    elif route == "decode":
        want = (SMS + base // 2) // base
    else:
        want = 1 if 2 * base >= SMS else -(-SMS // base)
    return QmmPlan(route, max(1, min(units, want)), tiles, unit, col_tiles, row_tiles, tile_n)


# fp32 reciprocals of the int8 and int4 maxima, as XLA folds them.
_RECIP = {q: (torch.tensor(1.0) / torch.tensor(q)).item() for q in (127.0, 7.0)}


def _scales(amax: torch.Tensor, qmax: float, stacked: bool) -> torch.Tensor:
    """amax / qmax (1 where amax is 0), in the form the JAX package computes
    for a single or a stacked weight (module docstring)."""
    s = amax * _RECIP[qmax] if stacked else amax / amax.new_tensor(qmax)
    return torch.where(amax > 0, s, 1.0)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class _Stacked:
    """What both weight classes share: the layer slice and the move."""

    values: torch.Tensor
    scales: torch.Tensor

    def __getitem__(self, index):
        """One layer of a stacked leaf: values[index], scales[index] (views)."""
        if self.values.ndim <= 2:
            raise IndexError("only a layer-stacked weight is indexed by layer")
        return dataclasses.replace(self, values=self.values[index], scales=self.scales[index])

    def to(self, device):
        return dataclasses.replace(self, values=self.values.to(device),
                                   scales=self.scales.to(device))

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.values, self.scales))


@dataclasses.dataclass(frozen=True)
class QuantizedWeight(_Stacked):
    """Per-output-column symmetric int8 weight. values [..., K_pad, N_pad]
    int8, scales [..., N_pad] f32; `in_dim` and `out` are the logical K and
    N."""

    values: torch.Tensor
    scales: torch.Tensor
    in_dim: int
    out: int
    impl: str = "pallas"

    @property
    def dtype(self):
        return torch.int8

    @property
    def shape(self):
        return tuple(self.values.shape[:-1]) + (self.out,)


@dataclasses.dataclass(frozen=True)
class QuantizedWeight4(_Stacked):
    """Group-wise symmetric int4 weight, nibble-packed (module docstring).
    values [..., K_pad // 2, N_pad] int8, scales [..., K_pad // 128, N_pad]
    f32."""

    values: torch.Tensor
    scales: torch.Tensor
    in_dim: int
    out: int
    impl: str = "pallas"

    @property
    def dtype(self):
        return torch.int4

    @property
    def shape(self):
        return tuple(self.values.shape[:-2]) + (2 * self.values.shape[-2], self.out)


QUANTIZED = (QuantizedWeight, QuantizedWeight4)


def _per_layer(w: torch.Tensor, one, cls):
    """Quantize a stacked [..., K, N] weight one layer at a time, so the
    fp32 working copy stays one layer's size."""
    flat = w.reshape((-1,) + tuple(w.shape[-2:]))
    first = one(flat[0])
    values = first.values.new_empty((flat.shape[0],) + tuple(first.values.shape))
    scales = first.scales.new_empty((flat.shape[0],) + tuple(first.scales.shape))
    values[0], scales[0] = first.values, first.scales
    for i in range(1, flat.shape[0]):
        q = one(flat[i])
        values[i], scales[i] = q.values, q.scales
    lead = tuple(w.shape[:-2])
    return cls(values=values.view(lead + tuple(first.values.shape)),
               scales=scales.view(lead + tuple(first.scales.shape)),
               in_dim=first.in_dim, out=first.out)


def quantize_weight(w: torch.Tensor, _stacked: bool = False) -> QuantizedWeight:
    """Quantize a [..., K, N] weight to int8 with per-N absmax scales,
    bit-identical to the JAX package's `quantize_weight`."""
    if w.ndim > 2:
        return _per_layer(w, lambda wl: quantize_weight(wl, _stacked=True), QuantizedWeight)
    k, n = w.shape
    wf = w.float()
    amax = wf.abs().amax(dim=0)
    scales = _scales(amax, 127.0, _stacked)
    q = torch.round(wf / scales).to(torch.int8)
    k_pad = _round_up(k, min(BLOCK_K, _round_up(k, LANES)))
    n_pad = _round_up(n, min(BLOCK_N8, _round_up(n, LANES)))
    values = q.new_zeros((k_pad, n_pad))
    values[:k, :n] = q
    padded = scales.new_ones(n_pad)
    padded[:n] = scales
    return QuantizedWeight(values=values, scales=padded, in_dim=k, out=n)


def dequantize_weight(qw: QuantizedWeight, dtype=torch.float32) -> torch.Tensor:
    """The exact dense weight the int8 product computes with (padding
    stripped): the parity oracle."""
    w = qw.values.float() * qw.scales[..., None, :]
    return w[..., : qw.in_dim, : qw.out].to(dtype)


def quantize_weight_int4(w: torch.Tensor, _stacked: bool = False) -> QuantizedWeight4:
    """Quantize a [..., K, N] weight to packed int4 with per-(128-row group,
    column) absmax scales, bit-identical to the JAX package's
    `quantize_weight_int4`."""
    if w.ndim > 2:
        return _per_layer(w, lambda wl: quantize_weight_int4(wl, _stacked=True),
                          QuantizedWeight4)
    k, n = w.shape
    k_pad = _round_up(k, min(BLOCK_K, _round_up(k, 2 * GROUP4)))
    n_pad = _round_up(n, min(BLOCK_N, _round_up(n, LANES)))
    wf = w.float().new_zeros((k_pad, n_pad))
    wf[:k, :n] = w
    grouped = wf.view(k_pad // GROUP4, GROUP4, n_pad)
    amax = grouped.abs().amax(dim=1)  # [G, N_pad]
    scales = _scales(amax, 7.0, _stacked)
    q = torch.clamp(torch.round(grouped / scales[:, None, :]), -8, 7).to(torch.int32)
    bk = min(BLOCK_K, k_pad)
    qb = q.view(k_pad // bk, 2, bk // 2, n_pad)
    lo, hi = qb[:, 0] + 8, qb[:, 1] + 8  # biased u = q + 8
    packed = (lo | (hi << 4)).to(torch.uint8).view(torch.int8).reshape(k_pad // 2, n_pad)
    return QuantizedWeight4(values=packed, scales=scales, in_dim=k, out=n)


def _unpack4(p: torch.Tensor):
    """int32 packed bytes -> (low, high) signed nibble values q = u - 8."""
    return (p & 0xF) - 8, ((p >> 4) & 0xF) - 8


def _dequant4_padded(qw: QuantizedWeight4) -> torch.Tensor:
    """f32 [..., K_pad, N_pad] dense image, padding kept (zero rows)."""
    k2, n_pad = qw.values.shape[-2:]
    k_pad = 2 * k2
    bk = min(BLOCK_K, k_pad)
    lead = tuple(qw.values.shape[:-2])
    p = qw.values.to(torch.int32).reshape(lead + (k_pad // bk, bk // 2, n_pad))
    lo, hi = _unpack4(p)
    q = torch.cat([lo, hi], dim=-2).reshape(lead + (k_pad // GROUP4, GROUP4, n_pad))
    return (q.float() * qw.scales[..., None, :]).reshape(lead + (k_pad, n_pad))


def dequantize_weight4(qw: QuantizedWeight4, dtype=torch.float32) -> torch.Tensor:
    """The exact dense weight the int4 product computes with (padding
    stripped): the parity oracle."""
    return _dequant4_padded(qw)[..., : qw.in_dim, : qw.out].to(dtype)


def kernel_report() -> str:
    """Registers, spill bytes and shared memory of every B10 / B11 kernel
    instantiation, as the card's runtime reports them."""
    return _build.runtime_report(QMM8.source, "fact_qmm_report")


def quantized_matmul_plain(x: torch.Tensor, qw) -> torch.Tensor:
    """Plain version of B10 / B11 on any device: x [..., K] times the
    dequantized weight in fp32, rounded to x's dtype. For int8 the scale
    multiplies the fp32 product, as in the kernel."""
    k = x.shape[-1]
    xf = x.float()
    if isinstance(qw, QuantizedWeight4):
        y = xf @ _dequant4_padded(qw)[..., :k, :]
    else:
        y = (xf @ qw.values[..., :k, :].float()) * qw.scales
    return y[..., : qw.out].to(x.dtype)


def quantized_matmul(x: torch.Tensor, qw, *, route: str | None = None,
                     splits: int | None = None) -> torch.Tensor:
    """x [..., K] @ qw -> [..., out] in x's dtype (fp32 accumulation).

    `qw` is one layer's `QuantizedWeight` (kernel B10 on CUDA) or
    `QuantizedWeight4` (kernel B11). x's K may be anything up to the
    weight's K_pad: the rows past it are zero. `route` and `splits` force
    the kernels' design and K splits (`qmm_plan`); by default the plan picks
    them from the shapes."""
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, qw)
    int4 = isinstance(qw, QuantizedWeight4)
    if x.dtype not in ACT_DTYPES:
        raise NotImplementedError(
            f"quantized matmul kernels take bf16 / f16 activations, got {x.dtype}")
    vals, scales = qw.values, qw.scales
    if vals.ndim != 2:
        raise ValueError(f"take one layer of a stacked weight first (w[li]), got values "
                         f"{list(vals.shape)}")
    _build.check_cuda_tensor("values", vals, torch.int8)
    if not vals.is_contiguous():
        raise ValueError("quantized values must be contiguous")
    k_pad = vals.shape[0] * (2 if int4 else 1)
    n_pad = vals.shape[1]
    want = (k_pad // GROUP4, n_pad) if int4 else (n_pad,)
    if (scales.dtype != torch.float32 or scales.device != vals.device
            or tuple(scales.shape) != want or not scales.is_contiguous()):
        raise ValueError(f"scales must be a contiguous float32 {list(want)} tensor on the "
                         f"values' device, got {scales.dtype} {list(scales.shape)}")
    if x.device != vals.device:
        raise ValueError(f"x is on {x.device}, the weight on {vals.device}")
    lead, k = x.shape[:-1], x.shape[-1]
    if k > k_pad or n_pad % LANES or k_pad % (2 * GROUP4 if int4 else LANES):
        raise ValueError(f"x's K {k} against a weight of padded shape {k_pad} x {n_pad}")
    x2 = x.reshape(-1, k)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    t = x2.shape[0]
    y = torch.empty((t, qw.out), dtype=x.dtype, device=x.device)
    if t == 0:
        return y.view(*lead, qw.out)
    es = x2.element_size()
    vec = x2.data_ptr() % 16 == 0 and (x2.stride(0) * es) % 16 == 0
    plan = qmm_plan(t, k, qw.out, k_pad, n_pad, int4, vec, route, splits)
    ws = (torch.empty((plan.splits, t, qw.out), dtype=torch.float32, device=x.device)
          if plan.splits > 1 else None)
    (QMM4 if int4 else QMM8)(
        x2.data_ptr(), vals.data_ptr(), scales.data_ptr(), y.data_ptr(),
        0 if ws is None else ws.data_ptr(), t, k, qw.out, k_pad, n_pad, x2.stride(0),
        int(vec), ROUTES.index(plan.route), plan.splits, plan.tile_n,
        _build.DTYPE_CODES[x.dtype])
    return y.view(*lead, qw.out)
