"""Attention backward from the saved lse: the CUDA kernels B13a (dK, dV)
and B13b (dQ) and their plain version.

Port of flash_attention_cute_tpu/ops/flash_bwd.py. The recompute backward
of FlashAttention-2: from q, k, v, the forward's output o, its cotangent dO
and the forward's per-row lse (`flash_attention_fwd(..., return_lse=True)`:
log2 units of the scaled scores, +inf on a row with no visible key), it
recomputes p = exp2(s * log2(e) - lse) tile by tile and never holds a
[Sq, Skv] matrix in device memory. delta = rowsum(dO * O) is one fp32
PyTorch expression, as it is one XLA expression in the JAX package.

`flash_attention_bwd` routes on the device of `q`: a CPU tensor takes the
plain version, a CUDA tensor launches B13a then B13b (csrc/flash_bwd.cu),
which replace `_flash_bwd_dkv_kernel` and `_flash_bwd_dq_kernel`. The
kernels take bf16 / f16, every head dim from 1 to 512
(`_build.padded_head_dim(..., wide=True)`: a d runs in the layout of the
next of 64, 128, 256 and 512, its TMA boxes reading zeros past d, as the
JAX wrapper pads D to 128 lanes), bottom-right causal masking, the
sliding window, GQA / MQA (dK and dV sum over the q-head group inside a
block, deterministically) and strided views with the head dim
contiguous, which they read by TMA in place where their rows lie at a
16-byte stride (one padded copy of those that do not, `_build.rows`);
dq, dk and dv come at rows of `_build.row_pitch(d)`. What they do not
take raises (the soft cap is not an argument here, as in JAX; head dims
above 512 name ROADMAP.md A14); nothing falls back. The TPU block
arguments `block_q` / `block_kv` are accepted and ignored.

B13a runs one block per (key block, kv head, batch row): 128 keys in the
layouts of D 64 / 128, 64 in D 256's and D 512's (`key_block`: d
136-512), whose kernels have layouts of their own to fit the H100's shared
memory and registers. D 512's B13a also runs two blocks a key block (grid
y of the forward's wide layout, folded into the grid), each for 256 of dK's
and dV's columns, over q tiles of 32 rows (`q_tile`). Where those blocks
are too few to fill the card, `dkv_splits` (pure Python, from the shapes
alone) cuts each block's walk over the group's q tiles into parts, one
block each, whose fp32 partials a second pass of the same C call adds in
split order: the result still repeats bit for bit.

The kernels read the lse and delta rows by bulk copies of whole 64- or
128-row tiles, so they take both as fp32 [B, Hq, Sq rounded up to
ROW_PAD] buffers, +inf and 0 past Sq (`padded_rows`). delta is computed
into one; the lse is copied into one only when Sq is not a multiple of
ROW_PAD (B * Hq * Sq * 4 bytes).
"""

from __future__ import annotations

import math

import torch

from flash_attention_cute_tpu_torch.dispatch import NUM_SMS
from flash_attention_cute_tpu_torch.ops import _build
from flash_attention_cute_tpu_torch.ops.reference import prefill_mask

LOG2E = math.log2(math.e)
ROW_PAD = 128  # csrc/flash_bwd.cu kRowPad: the lse / delta rows a B13b block reads
KEY_BLOCK = 128  # keys of a B13a block in D 64 / 128's layouts (csrc/flash_bwd.cu kBlock)
KEY_BLOCK_D256 = 64  # keys of a B13a block in D 256's and D 512's layouts (kTile)
Q_TILE = 64  # q rows of a B13a tile, at every head dim up to 256
Q_TILE_D512 = 32  # in D 512's layout (kRows512: flash_bwd_dkv_kernel_d512)
CHUNKS_D512 = 2  # B13a blocks a key block in D 512's layout: 256 columns each
MAX_SPLITS = 8
MIN_SPLIT_TILES = 4  # q tiles a split walks at the least, on the longest walk

P, I, L, F = _build.P, _build.I, _build.L, _build.F
_ARGS = [P] * 8 + [I] * 6 + [L] * 12 + [F, F, I, I, I, I, P, I, P]
# One C entry point, counted as two kernels by its `dkv` argument.
DKV = _build.Kernel("flash_bwd_dkv", "flash_bwd.cu", "fact_flash_bwd", _ARGS)
DQ = _build.Kernel("flash_bwd_dq", "flash_bwd.cu", "fact_flash_bwd", _ARGS)


def key_block(head_dim: int) -> int:
    """Keys of a B13a block at this head dim: those of the layout it runs
    in (raises for a head dim no layout takes)."""
    layout = _build.padded_head_dim(head_dim, "backward", wide=True)
    return KEY_BLOCK_D256 if layout >= 256 else KEY_BLOCK


def q_tile(head_dim: int) -> int:
    """q rows of a B13a tile at this head dim: its layout's."""
    layout = _build.padded_head_dim(head_dim, "backward", wide=True)
    return Q_TILE_D512 if layout == 512 else Q_TILE


def dkv_splits(batch: int, hkv: int, group: int, sq: int, skv: int, head_dim: int = 128) -> int:
    """Parts into which B13a cuts each key block's walk (1: no split).

    A block (`key_block(head_dim)` keys; in D 512's layout CHUNKS_D512
    blocks a key block) walks up to group x ceil(Sq / `q_tile(head_dim)`)
    q tiles. Split only while the blocks cover at most half the SMs: then
    to about one block an SM (NUM_SMS // blocks), at most MAX_SPLITS, and
    no finer than MIN_SPLIT_TILES tiles a part on the longest walk. Each
    part beyond the first costs an fp32 round trip of dK and dV through the
    workspace."""
    chunks = CHUNKS_D512 if q_tile(head_dim) == Q_TILE_D512 else 1
    blocks = -(-skv // key_block(head_dim)) * chunks * hkv * batch
    if blocks == 0 or 2 * blocks > NUM_SMS:
        return 1
    walk = group * -(-sq // q_tile(head_dim))
    return max(1, min(NUM_SMS // blocks, MAX_SPLITS, walk // MIN_SPLIT_TILES))


def padded_rows(x: torch.Tensor, sq: int, fill: float) -> torch.Tensor:
    """Per-row fp32 values [B, Hq, Sq] as the kernels read them: contiguous
    [B, Hq, Sq rounded up to ROW_PAD], `fill` past Sq. `x` itself when it
    already is such a buffer (an lse at Sq a multiple of ROW_PAD)."""
    width = -(-sq // ROW_PAD) * ROW_PAD
    if (x.shape[-1] == width and x.dtype == torch.float32 and x.is_contiguous()
            and x.data_ptr() % 16 == 0):
        return x
    return torch.nn.functional.pad(x[..., :sq].float(), (0, width - sq), value=fill).contiguous()


def kernel_report() -> str:
    """Registers, spill bytes and shared memory of every B13a / B13b kernel
    instantiation, as the card's runtime reports them."""
    return _build.runtime_report(DKV.source, "fact_bwd_report")


def flash_attention_bwd_plain(q, k, v, o, do, lse, sm_scale=None, causal=False, window=None,
                              block_q=0, block_kv=0):
    """Plain version of B13a + B13b on any device: the fp32 recompute from
    the lse, (dq, dk, dv) in the input dtypes."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    scale = d ** -0.5 if sm_scale is None else sm_scale
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s2 = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (scale * LOG2E)
    allowed = prefill_mask(sq, skv, causal, window, q.device)
    p = torch.where(allowed, torch.exp2(s2 - lse.float()[..., None]), 0.0)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = (torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale).view(b, hkv, group, skv, d).sum(2)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof).view(b, hkv, group, skv, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    sm_scale: float | None = None,
    causal: bool = False,
    window: int | None = None,
    block_q: int = 0,
    block_kv: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ, dK, dV of prefill attention.

    Args:
      q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D], Hq % Hkv == 0; o, do:
        [B, Hq, Sq, D] (the forward's output and its cotangent); any
        strides with the head dim contiguous.
      lse: [B, Hq, Sq] from `flash_attention_fwd(..., return_lse=True)` of
        this package or of the JAX package (the same convention).
      sm_scale, causal, window: those of the forward.
      block_q, block_kv: accepted for call-site parity, ignored.

    Returns (dq [B, Hq, Sq, D], dk, dv [B, Hkv, Skv, D]) in the dtypes of
    q, k, v; on CUDA at rows of `_build.row_pitch(D)`, contiguous where D is
    a multiple of 8.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, sm_scale, causal, window)
    window = _build.window_arg(window)
    if window >= skv:
        window = 0  # cannot bind, as in the forward
    if q.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(f"backward kernels take bf16/f16, got {q.dtype}")
    _build.padded_head_dim(d, "backward", wide=True)
    if (hq % hkv or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or o.shape != q.shape or do.shape != q.shape or lse.shape != (b, hq, sq)):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"o {tuple(o.shape)} do {tuple(do.shape)} lse {tuple(lse.shape)}")
    q, k, v, do = (_build.rows(name, t, q.dtype)
                   for name, t in (("q", q), ("k", k), ("v", v), ("do", do)))
    if not (q.device == k.device == v.device == do.device == o.device == lse.device):
        raise ValueError("q, k, v, o, do, lse must be on one device")

    lse = padded_rows(lse, sq, math.inf)
    delta = padded_rows((do.float() * o.float()).sum(-1), sq, 0.0)
    dq = _build.out_rows((b, hq, sq, d), q.dtype, q.device)
    dk = _build.out_rows((b, hkv, skv, d), k.dtype, q.device)
    dv = _build.out_rows((b, hkv, skv, d), v.dtype, q.device)
    if dk.numel():
        launch(DKV, q, k, v, do, lse, delta, dk, dv, sm_scale, causal, window)
    if dq.numel():
        launch(DQ, q, k, v, do, lse, delta, dq, None, sm_scale, causal, window)
    return dq, dk, dv


def launch(kernel, q, k, v, do, lse, delta, out0, out1, sm_scale, causal, window: int,
           splits: int | None = None) -> None:
    """One launch of B13a (`DKV`: out0 = dK, out1 = dV, split as `dkv_splits`
    plans, or in `splits` parts: for comparisons only) or B13b (`DQ`: out0 =
    dQ) on inputs `flash_attention_bwd` has checked (window 0 for none); lse
    and delta [B, Hq, Sq], or already padded (`padded_rows`)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    q, k, v, do = (_build.rows(name, t, q.dtype)
                   for name, t in (("q", q), ("k", k), ("v", v), ("do", do)))
    for name, out in (("out0", out0), ("out1", out1)):
        if out is not None:
            _build.check_out_rows(name, out, _build.row_pitch(d))
    lse, delta = padded_rows(lse, sq, math.inf), padded_rows(delta, sq, 0.0)
    ws = None
    if kernel is DKV:
        if splits is None:
            splits = dkv_splits(b, hkv, hq // hkv, sq, skv, d)
        if splits > 1:
            ws = torch.empty((2, splits, b, hkv, skv, _build.row_pitch(d)), dtype=torch.float32,
                             device=q.device)
    else:
        splits = 1
    with torch.cuda.device(q.device):
        kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
               delta.data_ptr(), out0.data_ptr(), None if out1 is None else out1.data_ptr(),
               b, hq, hkv, sq, skv, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *do.stride()[:3], float(sm_scale) * LOG2E, float(sm_scale), int(causal), window,
               _build.DTYPE_CODES[q.dtype], int(kernel is DKV),
               None if ws is None else ws.data_ptr(), splits)
