"""Named model-shape presets, runnable with random weights."""

from __future__ import annotations

import torch

from flash_attention_cute_tpu_torch.models.config import tiny_test_config
from flash_attention_cute_tpu_torch.models.llama import llama2_7b_config, llama3_8b_config

PRESETS = {
    "llama2-7b": llama2_7b_config,
    "llama3-8b": llama3_8b_config,
    # CPU-runnable shape for smoke tests.
    "tiny": lambda dtype=torch.bfloat16: tiny_test_config(dtype=dtype),
}
# Presets of the JAX package whose families are later slices of the port.
LATER = ("qwen2-7b", "gemma2-9b", "mistral-7b")


def get_preset(name: str, dtype=torch.bfloat16):
    if name in LATER:
        raise NotImplementedError(
            f"preset {name!r}: its model family is ROADMAP.md A10"
        )
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name](dtype=dtype)
