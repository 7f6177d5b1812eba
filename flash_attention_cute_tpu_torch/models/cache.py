"""KV caches: fixed-capacity buffers plus per-row lengths.

`KVCache` holds K/V in the model's dtype. Its buffers are allocated with
`torch.empty`: positions at or past a row's length hold uninitialised
memory (possibly NaN). No attention path reads them: the decode kernel
never loads past `lengths`, and the plain versions zero those positions out
of their products. The model writes new K/V into the buffers in place.

Both caches lay each row of head_dim values at the pitch the kernels read
through TMA, `_build.row_pitch(head_dim, element size)`: the tensors are
views of head_dim columns of buffers that wide, whose pitch columns are
zeros. At a head dim of a multiple of 8 (16 over one-byte values) the
pitch is head_dim and the tensors are contiguous.

`QuantizedKVCache` (port of the JAX package's) holds int8 / float8_e4m3fn
values with one f32 scale per token and kv head; the model quantizes each
new row as it writes it (kernel QA) and decode attention folds the scales
in (kernel B7, ops/quantized.py).
"""

from __future__ import annotations

import dataclasses

import torch

from flash_attention_cute_tpu_torch.ops import _build
from flash_attention_cute_tpu_torch.ops.quantized import QuantizedKV


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
            k=_build.empty_rows(shape, dtype, device),
            v=_build.empty_rows(shape, dtype, device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.k.shape[3]

    @property
    def batch(self) -> int:
        return self.k.shape[1]

    def update_layer(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        """Write k_new / v_new [B, Hkv, S, D] into layer `layer` at each
        row's length, in place, and return the cache (lengths unchanged: the
        model advances them once after the last layer). As the JAX
        package's `dynamic_update_slice`, a start past C - S is clamped to
        C - S."""
        b, hkv, s, _ = k_new.shape
        dev = self.k.device
        start = self.lengths.clamp(0, max(self.capacity - s, 0))
        rows = torch.arange(b, device=dev)[:, None, None]
        heads = torch.arange(hkv, device=dev)[None, :, None]
        slots = (start[:, None] + torch.arange(s, device=dev))[:, None, :]
        self.k[layer][rows, heads, slots] = k_new.to(self.k.dtype)
        self.v[layer][rows, heads, slots] = v_new.to(self.v.dtype)
        return self

    def advance(self, num_tokens) -> "KVCache":
        """The cache with lengths + num_tokens (an int or a [B] tensor);
        the buffers are shared."""
        return dataclasses.replace(self, lengths=self.lengths + num_tokens)


@dataclasses.dataclass
class QuantizedKVCache:
    """k_values/v_values: [num_layers, batch, num_kv_heads, capacity,
    head_dim] int8 or float8_e4m3fn; k_scales/v_scales: [num_layers, batch,
    num_kv_heads, capacity] float32; lengths: [batch] int32."""

    k_values: torch.Tensor
    k_scales: torch.Tensor
    v_values: torch.Tensor
    v_scales: torch.Tensor
    lengths: torch.Tensor

    @classmethod
    def create(cls, cfg, batch: int, capacity: int, dtype=torch.int8,
               device="cuda") -> "QuantizedKVCache":
        """Zero values and unit scales, as the JAX package's."""
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, capacity, cfg.head_dim)
        return cls(
            k_values=_build.empty_rows(shape, dtype, device, zero=True),
            k_scales=torch.ones(shape[:-1], dtype=torch.float32, device=device),
            v_values=_build.empty_rows(shape, dtype, device, zero=True),
            v_scales=torch.ones(shape[:-1], dtype=torch.float32, device=device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.k_values.shape[3]

    @property
    def batch(self) -> int:
        return self.k_values.shape[1]

    def layer(self, li: int) -> tuple[QuantizedKV, QuantizedKV]:
        """Layer `li`'s K and V caches (views, written in place)."""
        return (QuantizedKV(self.k_values[li], self.k_scales[li]),
                QuantizedKV(self.v_values[li], self.v_scales[li]))
