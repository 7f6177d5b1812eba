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
# heuristic aims to give every one of them a block.
NUM_SMS = 132


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """Tile sizes of the CUDA kernels (compiled in: csrc/*.cu)."""
    block_q: int = 64  # prefill: query rows per block
    block_kv: int = 64  # prefill: keys per tile
    # Decode path
    decode_block_kv: int = 64  # keys per softmax step
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


def decode_num_splits(batch: int, num_kv_heads: int, capacity: int) -> int:
    """Splits of the KV axis so that batch * heads * splits covers the SMs,
    without splits shorter than one 64-key tile."""
    want = -(-NUM_SMS // max(batch * num_kv_heads, 1))
    return max(1, min(want, capacity // BlockConfig.decode_block_kv))


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
