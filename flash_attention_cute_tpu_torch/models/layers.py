"""Transformer building blocks as plain functions on tensors.

Weights are stored [in, out], the layout of the JAX package, so a
projection is `x @ W` and converted parameters need no transpose. The cast
points follow the JAX package so that bf16 runs round at the same places:
RMSNorm in fp32 and cast back, RoPE cos/sin computed in fp32 and cast to
the model dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from flash_attention_cute_tpu_torch.models.config import ModelConfig


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32, cast back to x's dtype."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * weight.float()).to(x.dtype)


def rope_inv_freq(cfg: ModelConfig, device=None) -> torch.Tensor:
    """Inverse frequencies [D/2] fp32, with the default / linear / dynamic /
    llama3 scaling variants. "dynamic" NTK is evaluated at
    max_position_embeddings, as in the JAX package."""
    d = cfg.head_dim
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    inv = 1.0 / (cfg.rope_theta ** exps)
    sc = cfg.rope_scaling
    if sc is None or sc.rope_type == "default":
        return inv
    if sc.rope_type == "linear":
        return inv / sc.factor
    if sc.rope_type == "dynamic":
        seq = cfg.max_position_embeddings
        orig = sc.original_max_position_embeddings or seq
        alpha = (sc.factor * seq / orig) - (sc.factor - 1)
        base = cfg.rope_theta * alpha ** (d / (d - 2))
        return 1.0 / (base ** exps)
    if sc.rope_type == "llama3":
        low = sc.original_max_position_embeddings / sc.low_freq_factor
        high = sc.original_max_position_embeddings / sc.high_freq_factor
        wavelen = 2 * math.pi / inv
        smooth = (sc.original_max_position_embeddings / wavelen - sc.low_freq_factor) / (
            sc.high_freq_factor - sc.low_freq_factor
        )
        smooth = smooth.clamp(0.0, 1.0)
        scaled = (1 - smooth) * inv / sc.factor + smooth * inv
        return torch.where(
            wavelen > low, inv / sc.factor, torch.where(wavelen < high, inv, scaled)
        )
    raise ValueError(f"unknown rope_type {sc.rope_type}")


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor, dtype):
    """positions [B, S] -> cos, sin [B, S, D] (half-dim frequencies tiled)."""
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, S, D]; cos/sin [B, S, D] (rotate-half convention)."""
    c = cos[:, None]
    s = sin[:, None]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * c + rotated * s


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for a plain [in, out] weight (quantized weights: ROADMAP.md A8)."""
    return x @ w


def mlp(x: torch.Tensor, p: dict, activation: str = "silu") -> torch.Tensor:
    """SwiGLU: down(silu(gate(x)) * up(x))."""
    if activation != "silu":
        raise NotImplementedError(f"activation {activation!r} is ROADMAP.md A10")
    return dense(F.silu(dense(x, p["gate_proj"])) * dense(x, p["up_proj"]), p["down_proj"])


def qkv_project(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """x [B, S, E] -> q [B, Hq, S, D], k/v [B, Hkv, S, D] (transposed views)."""
    b, s, _ = x.shape
    q = dense(x, p["q_proj"]).view(b, s, cfg.num_q_heads, cfg.head_dim).transpose(1, 2)
    k = dense(x, p["k_proj"]).view(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    v = dense(x, p["v_proj"]).view(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    return q, k, v


def attention_output(attn: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """attn [B, Hq, S, D] -> o_proj output [B, S, E]."""
    b, _, s, _ = attn.shape
    attn = attn.transpose(1, 2).reshape(b, s, cfg.num_q_heads * cfg.head_dim)
    return dense(attn, p["o_proj"])


def layer_tail(x: torch.Tensor, attn: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    """Residual tail of a Llama layer: output projection, then the MLP."""
    x = x + attention_output(attn, lp, cfg)
    h = rms_norm(x, lp["post_ln"], cfg.rms_norm_eps)
    return x + mlp(h, lp, cfg.hidden_activation)
