"""Parameters of the JAX package -> parameters of the port.

Both packages store projections [in, out] and stack layers on a leading
axis, so the conversion copies arrays one for one and transposes nothing.
(HF state-dict conversion, which does transpose, is ROADMAP.md A5.)
Quantized leaves (the JAX `QuantizedWeight` / `QuantizedWeight4`) become
the port's classes of the same names, with the same packed values and
scales; their `impl` is carried along, and the port's products read it
nowhere (they route on the tensors' device).
"""

from __future__ import annotations

import numpy as np
import torch

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
