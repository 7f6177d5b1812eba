"""Llama family configurations."""

from __future__ import annotations

import torch

from flash_attention_cute_tpu_torch.models.config import ModelConfig, RopeScaling


def llama_config_from_hf(hf_config, dtype=torch.bfloat16) -> ModelConfig:
    """Map a transformers `LlamaConfig` (or dict) to ModelConfig."""
    if isinstance(hf_config, dict):
        get = lambda k, d=None: hf_config.get(k, d)  # noqa: E731
    else:
        get = lambda k, d=None: getattr(hf_config, k, d)  # noqa: E731

    head_dim = get("head_dim") or get("hidden_size") // get("num_attention_heads")
    rs = get("rope_scaling")
    rope_scaling = None
    if rs:
        rope_scaling = RopeScaling(
            rope_type=rs.get("rope_type", rs.get("type", "default")),
            factor=rs.get("factor", 1.0),
            low_freq_factor=rs.get("low_freq_factor", 1.0),
            high_freq_factor=rs.get("high_freq_factor", 4.0),
            original_max_position_embeddings=rs.get(
                "original_max_position_embeddings",
                get("max_position_embeddings", 8192),
            ),
        )
    return ModelConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_layers=get("num_hidden_layers"),
        num_q_heads=get("num_attention_heads"),
        num_kv_heads=get("num_key_value_heads", get("num_attention_heads")),
        head_dim=head_dim,
        max_position_embeddings=get("max_position_embeddings", 4096),
        rms_norm_eps=get("rms_norm_eps", 1e-6),
        rope_theta=get("rope_theta", 10000.0),
        rope_scaling=rope_scaling,
        attention_bias=bool(get("attention_bias", False)),
        tie_word_embeddings=bool(get("tie_word_embeddings", False)),
        dtype=dtype,
    )


def llama3_8b_config(dtype=torch.bfloat16) -> ModelConfig:
    """Llama-3-8B shapes."""
    return ModelConfig(
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_q_heads=32,
        num_kv_heads=8,
        head_dim=128,
        max_position_embeddings=8192,
        rms_norm_eps=1e-5,
        rope_theta=500000.0,
        dtype=dtype,
    )


def llama2_7b_config(dtype=torch.bfloat16) -> ModelConfig:
    """Llama-2-7B shapes."""
    return ModelConfig(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=11008,
        num_layers=32,
        num_q_heads=32,
        num_kv_heads=32,
        head_dim=128,
        max_position_embeddings=4096,
        rms_norm_eps=1e-5,
        rope_theta=10000.0,
        dtype=dtype,
    )
