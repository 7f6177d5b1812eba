"""Input checks and the tile sizes of the CUDA attention kernels.

Routing is by the device of the tensors a call receives, inside each kernel
wrapper (ops/flash_fwd.py, ops/flash_decode.py): a CPU tensor takes the
plain PyTorch version, a CUDA tensor the kernel. There is no global device
probe.
"""

from __future__ import annotations

import dataclasses

import torch

# The Hopper card the kernels are built for has 132 SMs; the decode split
# heuristic fills them.
NUM_SMS = 132


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """Tile sizes of the CUDA kernels (compiled in: csrc/*.cu)."""
    block_q: int = 64  # prefill: query rows per block
    block_kv: int = 64  # prefill: keys per tile
    # Decode path
    decode_num_splits: int = 0  # 0 = heuristic in the decode wrapper


def select_block_config(
    *,
    dtype: torch.dtype,
    head_dim: int,
    q_len: int,
    kv_len: int,
    causal: bool,
) -> BlockConfig:
    """Tile sizes for a call signature.

    The kernels are compiled with one tile shape: 64 x 64 keeps the
    prefill block's Q, K and V^T tiles at 53 KB of shared memory and its
    accumulators in registers at D = 128, so several blocks share an SM.
    """
    return BlockConfig()


def decode_tile(head_dim: int) -> int:
    """Keys of a tile of the decode kernels D1, B5, B7 and B8
    (csrc/paged_decode.cuh, `DecodeTiles::kN`): 64 in the layout of head
    dim 64 (which runs every head dim up to 64), 16 in the wide layout of
    512 (257-512), else 32."""
    return 64 if head_dim <= 64 else 16 if head_dim > 256 else 32


# q rows a block of the decode kernels D1, B5, B7 and B8 holds
# (csrc/paged_decode.cuh: q staged for 32 rows, two m-tiles of 16).
DECODE_BLOCK_ROWS = 32


def decode_group_chunks(group: int) -> tuple[int, int]:
    """(chunks, rows) of a GQA group in the decode kernels D1, B5, B7 and
    B8: a group of at most 32 q rows is one chunk, a block's; a larger one
    is cut into c = ceil(G / 32) chunks of ceil(G / c) rows, a block each,
    the last holding the rest (71 -> 3 chunks of 24 / 24 / 23, 48 -> 24 /
    24). The wrappers pass both to the kernels, whose launch checks that
    the chunks cover the group (csrc/paged_decode.cuh)."""
    if group < 1:
        raise ValueError(f"a GQA group holds at least one q head, got {group}")
    chunks = -(-group // DECODE_BLOCK_ROWS)
    return chunks, -(-group // chunks)


def decode_num_splits(batch: int, num_kv_heads: int, capacity: int, head_dim: int,
                      group: int = 1) -> int:
    """Splits of the decode kernels D1, B5, B7 and B8 from shapes alone
    (never the live lengths): the count whose blocks (batch x kv heads x
    the group's chunks of `decode_group_chunks` x splits) fill the card's
    slots (132 SMs x the kernel's blocks an SM: one in the layouts of D 256
    and 512, which run every head dim above 128, two below) in the fewest waves for
    the work each split carries, i.e. the least
    ceil(blocks / slots) / splits, the fewer splits on a tie; at least one,
    and no more than the tiles of the capacity, so that no split is shorter
    than a tile."""
    slots = NUM_SMS * (1 if head_dim > 128 else 2)
    rows = max(batch * num_kv_heads * decode_group_chunks(group)[0], 1)
    most = max(1, min(capacity // decode_tile(head_dim), 2 * -(-slots // rows)))
    return min(range(1, most + 1), key=lambda s: (-(-rows * s // slots) / s, s))


def validate_inputs(q, k, v) -> None:
    """Shape and dtype preconditions of every attention route."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"q/k/v must be rank-4 [B, H, S, D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.shape != v.shape:
        raise ValueError(f"k and v shapes differ: {tuple(k.shape)} vs {tuple(v.shape)}")
    if q.shape[0] != k.shape[0]:
        raise ValueError(f"batch mismatch: {q.shape[0]} vs {k.shape[0]}")
    if q.shape[3] != k.shape[3]:
        raise ValueError(f"head_dim mismatch: {q.shape[3]} vs {k.shape[3]}")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(
            f"num q heads ({q.shape[1]}) must be a multiple of num kv heads "
            f"({k.shape[1]})"
        )
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"unsupported dtype {q.dtype}; need bf16/f16/f32")
    if q.shape[3] > 256:
        raise ValueError(f"head_dim {q.shape[3]} > 256 unsupported")
