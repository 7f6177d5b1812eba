"""Sequence (context) parallelism: attention over a sequence sharded along
one axis of a device mesh.

Port of flash_attention_cute_tpu/parallel/sequence.py. JAX runs each
function under `shard_map` with S sharded as P(None, None, axis, None);
here every rank of the axis's group calls it (SPMD) with its contiguous
shard [B, H, S_local, D] of the global [B, H, n * S_local, D] and gets its
shard of the output back:

  * `allgather_attention`: K / V all-gathered over the axis
    (`dist.all_gather`); each rank runs B4 (ops/flash_chunked.py) on its
    queries with q_offset = rank * S_local and kv_length = n * S_local. One
    collective; K / V memory O(S_global) a rank.
  * `ring_attention`: K / V chunks rotate around the ring (JAX's
    `ppermute`: `dist.batch_isend_irecv`, sent to rank + 1 and received from
    rank - 1) while each rank folds one chunk a step into its running
    (m, l, acc): each chunk's state is B4's (o, m, l) partials, merged by
    `_fold_partials` in log2 units. Non-causal, every chunk wholly visible
    (q_offset = S_local); causal with an even S_local, zig-zag stripes
    (rank z holds global stripes z and 2n - 1 - z of S_local / 2 rows,
    exchanged before the ring and back after it), so that every step
    computes one live partial; causal with an odd S_local, the contiguous
    chunks with the offsets S_local, 0 and -S_local (an earlier, its own
    and a later chunk, whose walk is empty). K / V memory O(S_local) a
    rank.

B4 runs on a CUDA tensor; on a CPU tensor `flash_attention_chunked` takes
its plain version, so one route serves every device (JAX's XLA `inner`
recurrence has no counterpart: it exists there because JAX's kernel route
off the TPU needs interpret mode). Head dims: B4's, every d from 1 to 512
(257-512 in the wide layout of 512, DeepSeek-V4-Flash's 512 among them),
as JAX's functions check none; above 512 B4 raises before any launch.

One rank's work is `allgather_rank` / `ring_rank`, a function of its index,
n and how its next chunk arrives (`rotate`). The entry points hand it the
collectives; `allgather_attention_unrolled` / `ring_attention_unrolled`
run every rank's work in turn in one process over the global tensors, the
next chunk taken from the list of all ranks' shards: the same kernel calls,
offsets and folds, only the exchange differs (chip_smoke.py drives the
ring so at full width on one card). The fold and the stripe exchange are
elementwise work that JAX leaves to XLA rather than Pallas, so they stay
plain PyTorch. The port skips JAX's last rotation, whose chunks no step
reads.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist

from flash_attention_cute_tpu_torch.ops.flash_chunked import flash_attention_chunked

# rotate(k, v, t): the (k, v) chunk this rank holds at step t + 1.
Rotate = Callable[[torch.Tensor, torch.Tensor, int], tuple]


def _axis(mesh, axis: str):
    """The axis's process group, this rank's index on it and its size."""
    group = mesh.get_group(axis)
    return group, mesh.get_local_rank(axis), dist.get_world_size(group)


def _permute(group, idx: int, pairs: list) -> list:
    """JAX's `ppermute` over `group`, batched: for each (x, perm) of
    `pairs` (perm: (source, destination) indices, a permutation), send x to
    idx's destination and receive the source's x. A fixed point keeps x.
    All transfers go in one `dist.batch_isend_irecv`, each pair with a tag
    of its own (two may join the same two ranks)."""
    ops, out = [], []
    for tag, (x, perm) in enumerate(pairs):
        dst = next(d for s, d in perm if s == idx)
        src = next(s for s, d in perm if d == idx)
        if dst == idx:
            out.append(x)
            continue
        x = x.contiguous()
        buf = torch.empty_like(x)
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group, tag))
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, src), group, tag))
        out.append(buf)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """x of every rank of `group`, concatenated along S (dim 2) in rank
    order: the list form of `dist.all_gather`, which gloo and NCCL take."""
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=2)


def _zigzag_perms(n: int):
    """Stripe g of the global sequence (2n stripes of S_local / 2) lives on
    zig-zag rank g if g < n, else 2n - 1 - g. Contiguous rank j holds
    stripes 2j (its low half) and 2j + 1: where each goes."""
    even = [(j, 2 * j if 2 * j < n else 2 * n - 1 - 2 * j) for j in range(n)]
    odd = [(j, 2 * j + 1 if 2 * j + 1 < n else 2 * n - 2 - 2 * j) for j in range(n)]
    return even, odd


def _to_zigzag(xs: list, group, idx: int, n: int) -> list:
    """Contiguous shards -> zig-zag shards (stripes idx, 2n - 1 - idx):
    each x's halves travel by the two stripe permutations, all in one
    batch; which half arrives as the low stripe depends on idx's parity."""
    even, odd = _zigzag_perms(n)
    half = xs[0].shape[2] // 2
    got = _permute(group, idx, [pair for x in xs
                                for pair in ((x[:, :, :half], even), (x[:, :, half:], odd))])
    out = []
    for r_even, r_odd in zip(got[0::2], got[1::2]):
        low, high = (r_even, r_odd) if idx % 2 == 0 else (r_odd, r_even)
        out.append(torch.cat([low, high], dim=2))
    return out


def _from_zigzag(x: torch.Tensor, group, idx: int, n: int) -> torch.Tensor:
    """The inverse exchange: each stripe back to its contiguous rank."""
    even, odd = _zigzag_perms(n)
    half = x.shape[2] // 2
    low, high = x[:, :, :half], x[:, :, half:]
    send_even, send_odd = (low, high) if idx % 2 == 0 else (high, low)
    r_lo, r_hi = _permute(group, idx, [(send_even, [(d, s) for s, d in even]),
                                       (send_odd, [(d, s) for s, d in odd])])
    return torch.cat([r_lo, r_hi], dim=2)


def _zigzag_shard(x: torch.Tensor, z: int, n: int) -> torch.Tensor:
    """Zig-zag rank z's shard of a global [B, H, S, D]: stripes z, 2n-1-z."""
    half = x.shape[2] // (2 * n)
    return torch.cat([x[:, :, z * half:(z + 1) * half],
                      x[:, :, (2 * n - 1 - z) * half:(2 * n - z) * half]], dim=2)


def _uses_zigzag(causal: bool, s_local: int) -> bool:
    return causal and s_local % 2 == 0


def _fold_partials(m, l, acc, m_c, l_c, o_u):
    """Fold one chunk's (o, m, l) partial into running log2-unit state."""
    m_new = torch.maximum(m, m_c)
    safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    a_old = torch.where(torch.isneginf(m), 0.0, torch.exp2(m - safe))
    a_new = torch.where(torch.isneginf(m_c), 0.0, torch.exp2(m_c - safe))
    l_next = a_old * l + a_new * l_c
    acc_next = a_old[..., None] * acc + a_new[..., None] * o_u
    return m_new, l_next, acc_next


def _partial(q, k, v, offset: int, sm_scale: float):
    """B4's partials of q against a whole chunk k / v at one q_offset."""
    b = q.shape[0]
    q_off = torch.full((b,), offset, dtype=torch.int32, device=q.device)
    kv_len = torch.full((b,), k.shape[2], dtype=torch.int32, device=q.device)
    return flash_attention_chunked(q, k, v, q_off, kv_len, sm_scale=sm_scale, causal=True,
                                   return_partials=True)


def _step_partials(q, k, v, src: int, idx: int, causal: bool, zigzag: bool, sm_scale: float):
    """The partials of one ring step, as (rows of the rank's state, (o, m, l)).

    Zig-zag (q, k, v hold stripes low = idx-or-src, high = 2n-1-...):
      own pair:  q_low x kv_low diagonal, and q_high x (kv_low ++ kv_high)
                 with offset S_local / 2 (full + diagonal in one call);
      src < idx: both q stripes see kv_low in full;
      src > idx: q_high sees the whole pair in full (q_low nothing).
    Contiguous: offset S_local (every key visible), 0 (own chunk) or
    -S_local (a later chunk: an empty walk, m = l = o = 0)."""
    s_local = q.shape[2]
    if not zigzag:
        off = s_local if not causal or src < idx else (0 if src == idx else -s_local)
        return [(slice(None), _partial(q, k, v, off, sm_scale))]
    half = s_local // 2
    low, high = slice(0, half), slice(half, None)
    if src == idx:
        return [(low, _partial(q[:, :, low], k[:, :, low], v[:, :, low], 0, sm_scale)),
                (high, _partial(q[:, :, high], k, v, half, sm_scale))]
    if src < idx:
        return [(slice(None), _partial(q, k[:, :, low], v[:, :, low], s_local, sm_scale))]
    return [(high, _partial(q[:, :, high], k, v, s_local, sm_scale))]


def ring_rank(q, k, v, idx: int, n: int, rotate: Rotate, causal: bool = True,
              sm_scale: float | None = None) -> torch.Tensor:
    """One rank's ring attention.

    Args:
      q, k, v: the rank's shard [B, H, S_local, D] in the layout the ring
        runs on: zig-zag stripes (idx, 2n - 1 - idx) when causal with an
        even S_local (`_uses_zigzag`), else contiguous chunk idx.
      idx, n: the rank's index on the ring and the ring's size.
      rotate: rotate(k, v, t) gives the chunk held at step t + 1, rank
        (idx - t - 1) % n's.

    Returns the rank's output in q's layout and dtype.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    b, hq, s_local, d = q.shape
    zigzag = _uses_zigzag(causal, s_local)
    m = torch.full((b, hq, s_local), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, s_local), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, s_local, d), dtype=torch.float32, device=q.device)
    for t in range(n):
        for rows, (o_u, m_c, l_c) in _step_partials(q, k, v, (idx - t) % n, idx, causal, zigzag,
                                                    sm_scale):
            folded = _fold_partials(m[:, :, rows], l[:, :, rows], acc[:, :, rows], m_c, l_c, o_u)
            if rows == slice(None):
                m, l, acc = folded
            else:
                for state, new in zip((m, l, acc), folded):
                    state[:, :, rows] = new
        if t + 1 < n:
            k, v = rotate(k, v, t)
    l_inv = torch.where(l == 0.0, 1.0, 1.0 / l)
    return (acc * l_inv[..., None]).to(q.dtype)


def allgather_rank(q, kg, vg, idx: int, n: int, causal: bool = True,
                   sm_scale: float | None = None, window: int | None = None) -> torch.Tensor:
    """One rank's all-gather attention: its S_local queries at global
    positions idx * S_local + r against the gathered kg / vg [B, Hkv,
    n * S_local, D]: B4 on a CUDA tensor, its plain version on a CPU one."""
    b, _, s_local, _ = q.shape
    q_off = torch.full((b,), idx * s_local, dtype=torch.int32, device=q.device)
    kv_len = torch.full((b,), n * s_local, dtype=torch.int32, device=q.device)
    return flash_attention_chunked(q, kg, vg, q_off, kv_len, sm_scale=sm_scale, causal=causal,
                                   window=window)


def allgather_attention(
    q: torch.Tensor,  # [B, H, S_local, D]: this rank's shard of S
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis: str = "sp",
    causal: bool = True,
    sm_scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Sequence-parallel attention via a K / V all-gather over `axis` of
    the `DeviceMesh` `mesh`; returns this rank's output shard."""
    group, idx, n = _axis(mesh, axis)
    kg, vg = _all_gather(k, group, n), _all_gather(v, group, n)
    return allgather_rank(q, kg, vg, idx, n, causal, sm_scale, window)


def ring_attention(
    q: torch.Tensor,  # [B, H, S_local, D]: this rank's shard of S
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis: str = "sp",
    causal: bool = True,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Sequence-parallel attention with O(S_local) K / V memory a rank;
    returns this rank's output shard."""
    group, idx, n = _axis(mesh, axis)
    ring = [(i, (i + 1) % n) for i in range(n)]

    def rotate(k_t, v_t, t):
        return tuple(_permute(group, idx, [(k_t, ring), (v_t, ring)]))

    if not _uses_zigzag(causal, q.shape[2]):
        return ring_rank(q, k, v, idx, n, rotate, causal, sm_scale)
    q, k, v = _to_zigzag([q, k, v], group, idx, n)
    out = ring_rank(q, k, v, idx, n, rotate, causal, sm_scale)
    return _from_zigzag(out, group, idx, n)


def _check_shards(q: torch.Tensor, n: int) -> int:
    if n < 1 or q.shape[2] % n:
        raise ValueError(f"S {q.shape[2]} does not split into {n} shards")
    return q.shape[2] // n


def allgather_attention_unrolled(q, k, v, n: int, causal: bool = True,
                                 sm_scale: float | None = None,
                                 window: int | None = None) -> torch.Tensor:
    """`allgather_attention` over n ranks, run rank by rank in one process
    on the global [B, H, S, D] tensors (the gathered K / V are k, v)."""
    s_local = _check_shards(q, n)
    return torch.cat([allgather_rank(q[:, :, i * s_local:(i + 1) * s_local], k, v, i, n, causal,
                                     sm_scale, window) for i in range(n)], dim=2)


def ring_attention_unrolled(q, k, v, n: int, causal: bool = True,
                            sm_scale: float | None = None) -> torch.Tensor:
    """`ring_attention` over n ranks, run rank by rank in one process on
    the global [B, H, S, D] tensors: each rank's `ring_rank` on its shard,
    its next chunk taken from the list of every rank's (contiguous, as a
    received chunk is). The same kernel calls, offsets and folds as the
    distributed ring, so the same bits."""
    s_local = _check_shards(q, n)
    zigzag = _uses_zigzag(causal, s_local)

    def shard(x, i):
        return _zigzag_shard(x, i, n) if zigzag else x[:, :, i * s_local:(i + 1) * s_local].contiguous()

    ks, vs = [shard(k, i) for i in range(n)], [shard(v, i) for i in range(n)]
    outs = []
    for idx in range(n):
        def rotate(k_t, v_t, t, idx=idx):
            j = (idx - t - 1) % n
            return ks[j], vs[j]

        outs.append(ring_rank(shard(q, idx), ks[idx], vs[idx], idx, n, rotate, causal, sm_scale))
    if not zigzag:
        return torch.cat(outs, dim=2)
    half = s_local // 2
    stripes = [None] * (2 * n)
    for z, out in enumerate(outs):
        stripes[z], stripes[2 * n - 1 - z] = out[:, :, :half], out[:, :, half:]
    return torch.cat(stripes, dim=2)
