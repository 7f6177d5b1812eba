"""Dense KV cache: fixed-capacity buffers plus per-row lengths.

The buffers are allocated with `torch.empty`: positions at or past a row's
length hold uninitialised memory (possibly NaN). No attention path reads
them: the decode kernel never loads past `lengths`, and the plain versions
zero those positions out of their products. The model writes new K/V into
the buffers in place.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KVCache:
    """k, v: [num_layers, batch, num_kv_heads, capacity, head_dim];
    lengths: [batch] int32, the valid prefix of each row."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @classmethod
    def create(cls, cfg, batch: int, capacity: int, dtype=None, device="cuda") -> "KVCache":
        dtype = dtype or cfg.dtype
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, capacity, cfg.head_dim)
        return cls(
            k=torch.empty(shape, dtype=dtype, device=device),
            v=torch.empty(shape, dtype=dtype, device=device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.k.shape[3]

    @property
    def batch(self) -> int:
        return self.k.shape[1]
