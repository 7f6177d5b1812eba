"""Monkeypatch HF transformers attention onto the port's kernels.

Port of the JAX package's `interop/torch_patch.py`. The QKV projections,
RoPE and the KV-cache update stay in HF's torch code; the attention core is
the custom op `flash_attention_cute_tpu_torch::forward`, which calls
`api.flash_attention_forward` on the tensors where they are. On CUDA that
launches the kernels: P for an unpadded prefill, B2 where a sliding window
binds, B4 for a right-padded prefill (`kv_length` with `q_offset = 0`) and
D1 + D2 for each decode step over HF's growing cache. CPU tensors take the
plain versions. Nothing crosses to another framework or to the host, apart
from the mask checks of `_padding_kv_lengths` (one synchronisation a layer
when a mask is given).

Usage:

    from flash_attention_cute_tpu_torch.interop import patch_llama
    patch_llama()                      # patches LlamaAttention.forward
    model = AutoModelForCausalLM.from_pretrained(..., attn_implementation="eager")

This module imports no `transformers`; `patch_*` import HF's modeling
modules when called.
"""

from __future__ import annotations

import torch

from flash_attention_cute_tpu_torch.api import flash_attention_forward
from flash_attention_cute_tpu_torch.models.layers import apply_rope

OP_NAME = "flash_attention_cute_tpu_torch::forward"


def _flash_attention_eager(q, k, v, softmax_scale, causal, window, kv_length=None):
    """[B, H, S, D] -> [B, H, S, D] through the dispatching API.

    `kv_length` ([B] int32 on q's device, or None) marks the valid kv
    prefix of a RIGHT-padded batch; with it a prefill is top-left aligned
    (`q_offset = 0`: row i is position i, since right padding keeps the
    real tokens at the front)."""
    q_offset = None
    if kv_length is not None and q.shape[2] > 1:
        q_offset = torch.zeros((q.shape[0],), dtype=torch.int32, device=q.device)
    return flash_attention_forward(q, k, v, softmax_scale=softmax_scale, causal=causal,
                                   kv_length=kv_length, q_offset=q_offset, window=window)


_custom_op = None


def _get_custom_op():
    """Register `flash_attention_cute_tpu_torch::forward` once, with a fake
    kernel, so that patched models trace under torch.compile, FakeTensor and
    meta devices. A registration failure raises: there is no eager
    fallback."""
    global _custom_op
    if _custom_op is not None:
        return _custom_op

    @torch.library.custom_op(
        OP_NAME, mutates_args=(),
        schema=("(Tensor q, Tensor k, Tensor v, float softmax_scale, bool causal, "
                "int window, Tensor? kv_length=None) -> Tensor"),
    )
    def _op(q, k, v, softmax_scale, causal, window, kv_length=None):
        return _flash_attention_eager(q, k, v, softmax_scale, causal,
                                      None if window <= 0 else window, kv_length).contiguous()

    @_op.register_fake
    def _op_fake(q, k, v, softmax_scale, causal, window, kv_length=None):
        # A fresh contiguous tensor, as the real op returns (q is often a
        # transposed view: empty_like would copy its strides).
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)

    def call(q, k, v, softmax_scale, causal, window, kv_length=None):
        return _op(q, k, v, softmax_scale, causal, 0 if window is None else int(window),
                   kv_length)

    _custom_op = call
    return _custom_op


def _flash_attention_core(q, k, v, softmax_scale, causal, window, kv_length=None):
    return _get_custom_op()(q, k, v, softmax_scale, causal, window, kv_length)


def _padding_kv_lengths(mask, skv, window):
    """Per-sequence valid kv length from an HF attention mask, or None.

    None when the mask keeps every position (or only excludes what the
    sliding window already does); a contiguous int32 [B] tensor on the
    mask's device for a RIGHT-padded batch (each row a prefix of ones).
    Left-padded, arbitrary and zero-length masks raise NotImplementedError:
    attending to padding would be silently wrong. The four checks read one
    small tensor back to the host."""
    if mask.dim() == 4:
        # A processed additive (float) or boolean [B, 1, Sq, Skv] mask: under
        # causal semantics the LAST query row sees every non-pad key.
        row = mask[:, 0, -1, :skv]
        if row.is_floating_point():
            valid = row > torch.finfo(row.dtype).min / 2
        else:
            valid = row.to(torch.bool)
    elif mask.dim() == 2:
        valid = mask[:, :skv].to(torch.bool)
    else:
        raise NotImplementedError(
            f"attention_mask of rank {mask.dim()} is not supported by the interop path")
    n = valid.shape[-1]
    lengths = valid.sum(-1)
    ar = torch.arange(n, device=valid.device)
    windowed = (((ar[None, :] >= n - int(window)) == valid).all() if window is not None
                else torch.zeros((), dtype=torch.bool, device=valid.device))
    full, empty, prefix, window_only = torch.stack([
        (lengths >= n).all(), (lengths == 0).any(),
        ((ar[None, :] < lengths[:, None]) == valid).all(), windowed,
    ]).tolist()
    if full:
        return None
    if empty:
        # A mask processor that fully masks padded QUERY rows makes the
        # probed last row all-False; length 0 would zero the sequence.
        raise NotImplementedError(
            "attention_mask marks an entire sequence invalid (inferred kv length 0); "
            "fully-masked query rows are not supported by the interop path")
    if prefix:
        return lengths.to(torch.int32).contiguous()
    if window_only and mask.dim() == 4:
        # A sliding-window causal mask with no padding: the kernels apply
        # the window themselves.
        return None
    raise NotImplementedError(
        "the interop path supports unpadded or RIGHT-padded attention masks; left-padded "
        "or arbitrary masks would silently attend to padding tokens (use "
        "tokenizer.padding_side = 'right', or the serving engine for generation)")


def attention_forward(
    self,
    hidden_states,
    position_embeddings=None,
    attention_mask=None,
    past_key_value=None,
    past_key_values=None,  # transformers >= 4.56 spells it plural
    cache_position=None,
    position_ids=None,
    **kwargs,
):
    """Replacement for HF (>= 4.48-style) `*Attention.forward`. Returns
    (attn_out, None)."""
    if past_key_value is None:
        past_key_value = past_key_values
    b, s, _ = hidden_states.shape
    cfg = self.config
    head_dim = getattr(self, "head_dim", cfg.hidden_size // cfg.num_attention_heads)
    num_kv = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)

    q = self.q_proj(hidden_states).view(b, s, -1, head_dim).transpose(1, 2)
    k = self.k_proj(hidden_states).view(b, s, num_kv, head_dim).transpose(1, 2)
    v = self.v_proj(hidden_states).view(b, s, num_kv, head_dim).transpose(1, 2)

    if position_embeddings is not None:
        cos, sin = position_embeddings  # HF's rotate-half convention
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if past_key_value is not None:
        k, v = past_key_value.update(k, v, self.layer_idx, {"cache_position": cache_position})

    # HF Qwen2's window rule: layers >= max_window_layers when enabled.
    window = None
    if getattr(cfg, "use_sliding_window", False) and getattr(cfg, "sliding_window", None):
        if self.layer_idx >= getattr(cfg, "max_window_layers", 0):
            window = cfg.sliding_window

    kv_length = None
    if attention_mask is not None:
        kv_length = _padding_kv_lengths(attention_mask, k.shape[2], window)
        if kv_length is not None:
            kv_length = kv_length.to(q.device)

    o = _flash_attention_core(q, k, v, softmax_scale=head_dim ** -0.5, causal=True,
                              window=window, kv_length=kv_length)
    o = o.transpose(1, 2).reshape(b, s, -1)
    return self.o_proj(o), None


def patch_llama() -> None:
    """LlamaAttention.forward = attention_forward."""
    from transformers.models.llama import modeling_llama

    modeling_llama.LlamaAttention.forward = attention_forward


def patch_qwen2() -> None:
    """Qwen2Attention.forward = attention_forward."""
    from transformers.models.qwen2 import modeling_qwen2

    modeling_qwen2.Qwen2Attention.forward = attention_forward
