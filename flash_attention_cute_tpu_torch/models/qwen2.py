"""Qwen2 family configurations.

Port of flash_attention_cute_tpu/models/qwen2.py. Qwen2 is the Llama trunk
with QKV projection biases, often tied word embeddings, and sliding-window
attention on the layers >= `max_window_layers` when a checkpoint enables
it (`ModelConfig.layer_window`); the reference implementation raises on
such checkpoints, the port runs them through its windowed kernels.
"""

from __future__ import annotations

import torch

from flash_attention_cute_tpu_torch.models.config import ModelConfig


def qwen2_config_from_hf(hf_config, dtype=torch.bfloat16) -> ModelConfig:
    """Map a transformers `Qwen2Config` (or dict) to ModelConfig."""
    if isinstance(hf_config, dict):
        get = lambda k, d=None: hf_config.get(k, d)  # noqa: E731
    else:
        get = lambda k, d=None: getattr(hf_config, k, d)  # noqa: E731

    head_dim = get("head_dim") or get("hidden_size") // get("num_attention_heads")
    return ModelConfig(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_layers=get("num_hidden_layers"),
        num_q_heads=get("num_attention_heads"),
        num_kv_heads=get("num_key_value_heads", get("num_attention_heads")),
        head_dim=head_dim,
        max_position_embeddings=get("max_position_embeddings", 32768),
        rms_norm_eps=get("rms_norm_eps", 1e-6),
        rope_theta=get("rope_theta", 1000000.0),
        attention_bias=True,  # Qwen2 always has QKV bias
        tie_word_embeddings=bool(get("tie_word_embeddings", False)),
        sliding_window=get("sliding_window"),
        use_sliding_window=bool(get("use_sliding_window", False)),
        max_window_layers=get("max_window_layers", 0) or 0,
        dtype=dtype,
    )


def qwen2_7b_config(dtype=torch.bfloat16) -> ModelConfig:
    """Qwen2-7B shapes (28 q / 4 kv heads; the published config sets
    use_sliding_window false)."""
    return ModelConfig(
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_layers=28,
        num_q_heads=28,
        num_kv_heads=4,
        head_dim=128,
        max_position_embeddings=32768,
        rms_norm_eps=1e-6,
        rope_theta=1000000.0,
        attention_bias=True,
        dtype=dtype,
    )
