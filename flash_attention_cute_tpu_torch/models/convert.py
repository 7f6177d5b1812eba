"""Parameters of the JAX package -> parameters of the port.

Both packages store projections [in, out] and stack layers on a leading
axis, so the conversion copies arrays one for one and transposes nothing.
(HF state-dict conversion, which does transpose, is ROADMAP.md A5.)
"""

from __future__ import annotations

import numpy as np
import torch


def _to_torch(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: carry the raw bits across
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(np_params: dict, device="cuda", dtype: torch.dtype | None = None) -> dict:
    """Convert the JAX parameter pytree, given as numpy arrays (for example
    `jax.tree.map(np.asarray, params)`), into the port's parameter dict.

    `dtype` casts every tensor; None keeps the arrays' own dtype.
    """
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _to_torch(x, device, dtype)

    unknown = set(np_params["layers"]) - {
        "input_ln", "post_ln", "q_proj", "k_proj", "v_proj", "o_proj",
        "gate_proj", "up_proj", "down_proj",
    }
    if unknown:
        raise NotImplementedError(
            f"parameters {sorted(unknown)} belong to later slices (ROADMAP.md A8/A10)"
        )
    return conv(np_params)
