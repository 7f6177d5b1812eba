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
from flash_attention_cute_tpu_torch.ops import _build
from flash_attention_cute_tpu_torch.ops.quantized_matmul import QUANTIZED, quantized_matmul


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
    """x [B, H, S, D]; cos/sin [B, S, D] (rotate-half convention). On the
    GPU, at a D whose rows are no whole 16 bytes, the result lies at rows of
    `_build.row_pitch(D)` (`_build.out_rows`; no kernel reads the pitch
    columns as data), as the kernels read it: the tensor RoPE builds
    anyway, so q and k reach them with no copy."""
    c = cos[:, None]
    s = sin[:, None]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    d = x.shape[-1]
    if x.device.type == "cpu" or _build.row_pitch(d, x.element_size()) == d:
        return x * c + rotated * s
    out = _build.out_rows(x.shape, torch.result_type(x, c), x.device)
    if torch.is_grad_enabled() and x.requires_grad:  # autograd takes no out=
        return out.copy_(x * c + rotated * s)
    return torch.add(x * c, rotated * s, out=out)


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain [in, out] weight, or through kernel B10 / B11 for
    one layer of an int8 / int4 quantized weight (ops/quantized_matmul.py)."""
    if isinstance(w, QUANTIZED):
        return quantized_matmul(x, w)
    return x @ w


def embed(params: dict, input_ids: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The embedding rows in the model dtype; with `cfg.scale_embeddings`
    (Gemma) times sqrt(hidden) rounded to the model dtype first, as the JAX
    package and HF do (a bf16 59.75 for 3584, not the fp32 59.87)."""
    x = params["embed"][input_ids].to(cfg.dtype)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=cfg.dtype)
    return x


def mlp(x: torch.Tensor, p: dict, activation: str = "silu") -> torch.Tensor:
    """Gated MLP: down(act(gate(x)) * up(x)), SwiGLU (silu) or GeGLU
    (gelu_tanh, Gemma2), with gate and up as one product for a fused layer
    (models/fuse.py)."""
    if "gate_up_proj" in p:
        gate, up = dense(x, p["gate_up_proj"]).chunk(2, dim=-1)
    else:
        gate, up = dense(x, p["gate_proj"]), dense(x, p["up_proj"])
    if activation == "silu":
        act = F.silu(gate)
    elif activation == "gelu_tanh":
        act = F.gelu(gate, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return dense(act * up, p["down_proj"])


def qkv_project(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """x [B, S, E] -> q [B, Hq, S, D], k/v [B, Hkv, S, D] (transposed views).
    A fused layer (models/fuse.py) runs one product and splits it. With
    `cfg.attention_bias` (Qwen2) the q/k/v biases, kept in the model dtype,
    are added after the products."""
    b, s, _ = x.shape
    hq = cfg.num_q_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    if "qkv_proj" in p:
        qkv = dense(x, p["qkv_proj"])
        if cfg.attention_bias:
            qkv = qkv + p["qkv_bias"]
        q, k, v = qkv.split([hq, hkv, hkv], dim=-1)
    else:
        q, k, v = dense(x, p["q_proj"]), dense(x, p["k_proj"]), dense(x, p["v_proj"])
        if cfg.attention_bias:
            q, k, v = q + p["q_bias"], k + p["k_bias"], v + p["v_bias"]
    q = q.view(b, s, cfg.num_q_heads, cfg.head_dim).transpose(1, 2)
    k = k.view(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    v = v.view(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    return q, k, v


def attention_output(attn: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """attn [B, Hq, S, D] -> o_proj output [B, S, E]."""
    b, _, s, _ = attn.shape
    attn = attn.transpose(1, 2).reshape(b, s, cfg.num_q_heads * cfg.head_dim)
    return dense(attn, p["o_proj"])


def logits(x: torch.Tensor, params: dict, cfg: ModelConfig) -> torch.Tensor:
    """fp32 logits of the final hidden states: the lm_head (B10 / B11 when
    quantized) or, for tied embeddings, the embedding table; with
    `cfg.final_logit_softcap` c (Gemma2) then c * tanh(logits / c). Outside
    autograd the cap runs in place: at a vocabulary of 256000 a 4608-token
    row of fp32 logits is 4.7 GB, and each temporary as large again."""
    lm_head = params.get("lm_head")
    if isinstance(lm_head, QUANTIZED):
        out = dense(x, lm_head).float()
    else:
        if lm_head is None:  # tied embeddings
            lm_head = params["embed"].T
        out = (x @ lm_head.to(x.dtype)).float()
    c = cfg.final_logit_softcap
    if c is None:
        return out
    if torch.is_grad_enabled() and out.requires_grad:
        return torch.tanh(out / c) * c
    return out.div_(c).tanh_().mul_(c)


def layer_tail(x: torch.Tensor, attn: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    """Residual tail of a layer: output projection, then the MLP. With
    `cfg.sandwich_norms` (Gemma2) the attention output is normed (`post_ln`,
    HF's post_attention_layernorm) before its residual add, and the MLP sits
    between `pre_ffw_ln` and `post_ffw_ln`."""
    a = attention_output(attn, lp, cfg)
    if cfg.sandwich_norms:
        x = x + rms_norm(a, lp["post_ln"], cfg.rms_norm_eps)
        h = rms_norm(x, lp["pre_ffw_ln"], cfg.rms_norm_eps)
        m = mlp(h, lp, cfg.hidden_activation)
        return x + rms_norm(m, lp["post_ffw_ln"], cfg.rms_norm_eps)
    x = x + a
    h = rms_norm(x, lp["post_ln"], cfg.rms_norm_eps)
    return x + mlp(h, lp, cfg.hidden_activation)
