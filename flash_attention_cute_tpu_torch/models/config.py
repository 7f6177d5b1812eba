"""Model configuration (the JAX package's fields, with a torch dtype).

The port runs the Llama architecture. The fields of other families
(attention bias, sliding windows, soft caps, Gemma2's norms and
activation) are kept so that configurations carry over unchanged;
`transformer.forward` raises on the ones this slice does not run.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    rope_type: str = "default"  # default | linear | dynamic | llama3
    factor: float = 1.0
    # llama3-specific
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_q_heads: int
    num_kv_heads: int
    head_dim: int
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: RopeScaling | None = None
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    sliding_window: int | None = None
    use_sliding_window: bool = False
    max_window_layers: int = 0
    logit_softcap: float | None = None
    hidden_activation: str = "silu"
    attention_scale: float | None = None  # None -> head_dim ** -0.5
    final_logit_softcap: float | None = None
    sandwich_norms: bool = False
    scale_embeddings: bool = False
    rms_norm_plus_one: bool = False
    layer_window_pattern: tuple | None = None
    dtype: Any = torch.bfloat16

    @property
    def q_per_kv(self) -> int:
        return self.num_q_heads // self.num_kv_heads

    def __post_init__(self):
        if self.num_q_heads % self.num_kv_heads:
            raise ValueError("num_q_heads must be a multiple of num_kv_heads")


def tiny_test_config(**overrides) -> ModelConfig:
    """A small config for unit tests (Llama-shaped GQA)."""
    base = dict(
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_q_heads=4,
        num_kv_heads=2,
        head_dim=16,
        max_position_embeddings=256,
        dtype=torch.float32,
    )
    base.update(overrides)
    return ModelConfig(**base)
