"""Named model-shape presets, runnable with random weights."""

from __future__ import annotations

import torch

from flash_attention_cute_tpu_torch.models.config import tiny_test_config
from flash_attention_cute_tpu_torch.models.gemma2 import gemma2_9b_config
from flash_attention_cute_tpu_torch.models.llama import llama2_7b_config, llama3_8b_config
from flash_attention_cute_tpu_torch.models.mistral import mistral_7b_config
from flash_attention_cute_tpu_torch.models.qwen2 import qwen2_7b_config

PRESETS = {
    "llama2-7b": llama2_7b_config,
    "llama3-8b": llama3_8b_config,
    "qwen2-7b": qwen2_7b_config,
    "mistral-7b": mistral_7b_config,
    "gemma2-9b": gemma2_9b_config,
    # CPU-runnable shape for smoke tests.
    "tiny": lambda dtype=torch.bfloat16: tiny_test_config(dtype=dtype),
}


def get_preset(name: str, dtype=torch.bfloat16):
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name](dtype=dtype)
