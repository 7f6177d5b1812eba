"""Weights into the port's parameter dict: from the JAX package's pytree,
and from HF checkpoints.

`params_from_jax`: both packages store projections [in, out] and stack
layers on a leading axis, so the conversion copies arrays one for one and
transposes nothing. Quantized leaves (the JAX `QuantizedWeight` /
`QuantizedWeight4`) become the port's classes of the same names, with the
same packed values and scales; their `impl` is carried along, and the
port's products read it nowhere (they route on the tensors' device).

`params_from_state_dict` / `head_params_from_state_dict` / `load_hf_model`
(ports of the JAX package's HF converters): an HF state dict stores each
Linear [out, in], so every projection is transposed once here, and each
value is cast from its own dtype to the config's, as the JAX converter's
fp32 staging then cast gives. Gemma's `+1` is added to the norm weights in
fp32 before the cast.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from flash_attention_cute_tpu_torch.models.gemma2 import gemma2_config_from_hf
from flash_attention_cute_tpu_torch.models.llama import llama_config_from_hf
from flash_attention_cute_tpu_torch.models.mistral import mistral_config_from_hf
from flash_attention_cute_tpu_torch.models.qwen2 import qwen2_config_from_hf
from flash_attention_cute_tpu_torch.ops.quantized_matmul import QuantizedWeight, QuantizedWeight4

LAYER_KEYS = {
    "input_ln", "post_ln", "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj", "qkv_proj", "gate_up_proj",
    "q_bias", "k_bias", "v_bias", "qkv_bias",  # Qwen2
    "pre_ffw_ln", "post_ffw_ln",  # Gemma2's sandwich norms
}


def _to_torch(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: carry the raw bits across
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def _quantized(leaf, device):
    """A JAX quantized leaf with numpy fields -> the port's class. The JAX
    classes tell int4 from int8 by their `dtype` (jnp.int4 / jnp.int8)."""
    cls = QuantizedWeight4 if "int4" in str(leaf.dtype) else QuantizedWeight
    return cls(values=_to_torch(leaf.values, device, torch.int8),
               scales=_to_torch(leaf.scales, device, torch.float32),
               in_dim=leaf.in_dim, out=leaf.out, impl=leaf.impl)


def params_from_jax(np_params: dict, device="cuda", dtype: torch.dtype | None = None) -> dict:
    """Convert the JAX parameter pytree, given as numpy arrays (for example
    `jax.tree.map(np.asarray, params)`, which keeps quantized leaves as
    their dataclasses with numpy fields), into the port's parameter dict.

    `dtype` casts every dense tensor; None keeps the arrays' own dtype.
    Quantized leaves keep int8 values and f32 scales.
    """
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if hasattr(x, "values") and hasattr(x, "scales"):
            return _quantized(x, device)
        return _to_torch(x, device, dtype)

    unknown = set(np_params["layers"]) - LAYER_KEYS
    if unknown:
        raise NotImplementedError(
            f"layer parameters {sorted(unknown)} are not in the port's models"
        )
    return conv(np_params)


_PREFIX = re.compile(r"^(model\.|transformer\.)")


def _normalize_key(k: str) -> str:
    return _PREFIX.sub("", k)


def _tensor(t) -> torch.Tensor:
    """A state-dict value (torch tensor or numpy array) as a tensor of its
    own dtype, where it lies."""
    return t.detach() if isinstance(t, torch.Tensor) else _to_torch(t, None, None)


def _cast(t: torch.Tensor, dtype, device, transpose=False) -> torch.Tensor:
    """A contiguous copy of `t` (or of its transpose) in `dtype` on `device`."""
    t = t.T if transpose else t
    return t.to(device=device, dtype=dtype, memory_format=torch.contiguous_format, copy=True)


def params_from_state_dict(state_dict: dict, cfg, with_lm_head: bool = True,
                           device="cuda") -> dict:
    """Convert an HF Llama / Qwen2 / Mistral / Gemma2 state dict to the
    port's parameter dict on `device`.

    Accepts `model.layers.N...` and `layers.N...` keys, torch tensors or
    numpy arrays. `with_lm_head=False` converts a trunk-only checkpoint
    (task-head checkpoints carry a head instead, see
    `head_params_from_state_dict`); with tied embeddings no `lm_head` is
    made either way."""
    sd = {_normalize_key(k): v for k, v in state_dict.items()}
    dt = cfg.dtype

    def get(k):
        if k not in sd:
            raise KeyError(f"missing weight {k!r}; have e.g. {list(sd)[:5]}")
        return _tensor(sd[k])

    def norm_w(k):
        w = get(k).float()
        if cfg.rms_norm_plus_one:  # Gemma's x * (1 + w), folded in fp32
            w = w + 1.0
        return _cast(w, dt, device)

    def stack(fmt, conv):
        return torch.stack([conv(fmt.format(i)) for i in range(cfg.num_layers)])

    def linear(k):  # [out, in] -> [in, out]
        return _cast(get(k), dt, device, transpose=True)

    layers = {
        "input_ln": stack("layers.{}.input_layernorm.weight", norm_w),
        "post_ln": stack("layers.{}.post_attention_layernorm.weight", norm_w),
        **{f"{n}_proj": stack(f"layers.{{}}.self_attn.{n}_proj.weight", linear)
           for n in ("q", "k", "v", "o")},
        **{f"{n}_proj": stack(f"layers.{{}}.mlp.{n}_proj.weight", linear)
           for n in ("gate", "up", "down")},
    }
    if cfg.attention_bias:
        for n in ("q", "k", "v"):
            layers[f"{n}_bias"] = stack(f"layers.{{}}.self_attn.{n}_proj.bias",
                                        lambda k: _cast(get(k), dt, device))
    if cfg.sandwich_norms:  # Gemma2's pre / post feed-forward norms
        layers["pre_ffw_ln"] = stack("layers.{}.pre_feedforward_layernorm.weight", norm_w)
        layers["post_ffw_ln"] = stack("layers.{}.post_feedforward_layernorm.weight", norm_w)

    params = {"embed": _cast(get("embed_tokens.weight"), dt, device), "layers": layers,
              "final_ln": norm_w("norm.weight")}
    if with_lm_head and not cfg.tie_word_embeddings:
        if "lm_head.weight" not in sd:  # outside the model.* prefix in HF checkpoints
            raise KeyError("lm_head.weight missing and embeddings not tied")
        params["lm_head"] = _cast(_tensor(sd["lm_head.weight"]), dt, device, transpose=True)
    return params


_HEADS = {  # head -> (HF name, whether it has a bias, the port's names)
    "sequence_classification": ("score", False, ("score",)),
    "token_classification": ("score", True, ("score", "score_bias")),
    "question_answering": ("qa_outputs", True, ("qa_outputs", "qa_outputs_bias")),
}


def head_params_from_state_dict(state_dict: dict, cfg, head: str, device="cuda") -> dict:
    """Convert an HF task-head checkpoint (trunk + head, no lm_head): `head`
    is "sequence_classification" (HF `score.weight`, no bias),
    "token_classification" (`score.{weight,bias}`) or "question_answering"
    (`qa_outputs.{weight,bias}`, 2 outputs)."""
    if head not in _HEADS:
        raise ValueError(f"unknown head {head!r}")
    params = params_from_state_dict(state_dict, cfg, with_lm_head=False, device=device)
    sd = {_normalize_key(k): v for k, v in state_dict.items()}
    hf_name, bias, names = _HEADS[head]
    params[names[0]] = _cast(_tensor(sd[f"{hf_name}.weight"]), cfg.dtype, device, transpose=True)
    if bias:
        params[names[1]] = _cast(_tensor(sd[f"{hf_name}.bias"]), cfg.dtype, device)
    return params


def load_hf_model(model_name_or_path: str, dtype=torch.bfloat16, device="cuda"):
    """Load config and weights from a local HF checkpoint directory through
    transformers (no download). The checkpoint is read in its stored dtype
    (`dtype="auto"`), not staged in fp32, and each value cast as
    `params_from_state_dict` does. Returns (cfg, params)."""
    if not os.path.isdir(model_name_or_path):
        raise ValueError(f"load_hf_model takes a local checkpoint directory, got "
                         f"{model_name_or_path!r}")
    import transformers

    hf_cfg = transformers.AutoConfig.from_pretrained(model_name_or_path, local_files_only=True)
    make = {"qwen2": qwen2_config_from_hf, "mistral": mistral_config_from_hf,
            "gemma2": gemma2_config_from_hf}.get(getattr(hf_cfg, "model_type", "llama"),
                                                 llama_config_from_hf)
    cfg = make(hf_cfg, dtype=dtype)
    with torch.device("cpu"):
        model = transformers.AutoModelForCausalLM.from_pretrained(
            model_name_or_path, dtype="auto", local_files_only=True)
    params = params_from_state_dict(model.state_dict(), cfg, device=device)
    del model
    return cfg, params
