"""Generation loops and sampling."""

from flash_attention_cute_tpu_torch.runtime.generate import generate, greedy_generate, prefill
from flash_attention_cute_tpu_torch.runtime.sampling import sample_token

__all__ = ["generate", "greedy_generate", "prefill", "sample_token"]
