"""Gemma 2 family configurations.

Port of flash_attention_cute_tpu/models/gemma2.py. Gemma 2 is the Llama
trunk with: alternating sliding-window and full-attention layers (a
periodic `layer_window_pattern`), tanh soft caps on the attention scores
and on the final logits, GeGLU MLPs (tanh-approximated GELU), sandwich
RMSNorms around both residual branches, (1 + w) RMSNorm weights (folded
into the stored weights at conversion), embeddings scaled by sqrt(hidden),
tied embeddings, and an attention scale from `query_pre_attn_scalar`
rather than the head dim.
"""

from __future__ import annotations

import torch

from flash_attention_cute_tpu_torch.models.config import ModelConfig


def gemma2_config_from_hf(hf_cfg, dtype=torch.bfloat16) -> ModelConfig:
    """Map a transformers `Gemma2Config` to ModelConfig."""
    window = getattr(hf_cfg, "sliding_window", None)
    # HF layer_types alternates sliding / full from layer 0: a period of two.
    layer_types = getattr(hf_cfg, "layer_types", None)
    if layer_types is not None and len(layer_types) >= 2:
        period = tuple(window if t == "sliding_attention" else None for t in layer_types[:2])
    else:
        period = (window, None)
    scalar = getattr(hf_cfg, "query_pre_attn_scalar", hf_cfg.head_dim)
    return ModelConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_q_heads=hf_cfg.num_attention_heads,
        num_kv_heads=hf_cfg.num_key_value_heads,
        head_dim=hf_cfg.head_dim,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        rms_norm_eps=hf_cfg.rms_norm_eps,
        rope_theta=hf_cfg.rope_theta,
        attention_bias=bool(getattr(hf_cfg, "attention_bias", False)),
        tie_word_embeddings=True,  # every Gemma 2 checkpoint ties
        logit_softcap=getattr(hf_cfg, "attn_logit_softcapping", None),
        final_logit_softcap=getattr(hf_cfg, "final_logit_softcapping", None),
        hidden_activation="gelu_tanh",
        attention_scale=float(scalar) ** -0.5,
        sandwich_norms=True,
        scale_embeddings=True,
        rms_norm_plus_one=True,
        layer_window_pattern=period if window else None,
        dtype=dtype,
    )


def gemma2_9b_config(dtype=torch.bfloat16) -> ModelConfig:
    """Gemma-2-9B shapes: head dim 256, a window of 4096 on the even layers,
    soft caps 50 (attention) and 30 (final logits)."""
    return ModelConfig(
        vocab_size=256000,
        hidden_size=3584,
        intermediate_size=14336,
        num_layers=42,
        num_q_heads=16,
        num_kv_heads=8,
        head_dim=256,
        max_position_embeddings=8192,
        rms_norm_eps=1e-6,
        rope_theta=10000.0,
        tie_word_embeddings=True,
        logit_softcap=50.0,
        final_logit_softcap=30.0,
        hidden_activation="gelu_tanh",
        attention_scale=256.0 ** -0.5,
        sandwich_norms=True,
        scale_embeddings=True,
        rms_norm_plus_one=True,
        layer_window_pattern=(4096, None),
        dtype=dtype,
    )
