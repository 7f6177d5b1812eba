"""Differentiable prefill attention: a `torch.autograd.Function` over the
forward with its lse and the recompute backward.

Port of flash_attention_cute_tpu/ops/autodiff.py (a `jax.custom_vjp`).
The forward is `flash_attention_fwd(..., return_lse=True)` (kernel P, or B2
where a window binds) and saves q, k, v, the output and the lse; the
backward is `flash_attention_bwd` (kernels B13a and B13b). Both route on
the device of q: on CPU tensors the same Function runs the plain forward
with its lse and the plain recompute backward, so the lse that crosses
from forward to backward is the one the kernels exchange on the card.
Layout [B, H, S, D] like `flash_attn_func`; GQA / MQA gradients of k and v
sum over the q-head group. The kernels take every head dim from 1 to 512
(`_build.padded_head_dim(..., wide=True)`); on CUDA tensors a head dim
above 512 (ROADMAP.md A14) raises before the forward launches.
"""

from __future__ import annotations

import torch

from flash_attention_cute_tpu_torch.ops import _build
from flash_attention_cute_tpu_torch.ops.flash_bwd import flash_attention_bwd
from flash_attention_cute_tpu_torch.ops.flash_fwd import flash_attention_fwd


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v); backward from the saved lse."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, window):
        if q.device.type != "cpu":  # refused before the forward runs, not at the backward
            _build.padded_head_dim(q.shape[-1], "backward", wide=True)
        out, lse = flash_attention_fwd(q, k, v, sm_scale=sm_scale, causal=causal, window=window,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (sm_scale, causal, window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:  # e.g. the expanded cotangent of a sum
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float | None = None,
    causal: bool = False,
    window: int | None = None,
) -> torch.Tensor:
    """Differentiable attention over q [B, Hq, Sq, D], k / v [B, Hkv, Skv,
    D]: kernel forward and backward on CUDA, plain versions on the CPU."""
    return FlashAttention.apply(q, k, v, sm_scale, causal, window)
