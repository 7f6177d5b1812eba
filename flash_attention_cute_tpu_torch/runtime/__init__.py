"""Generation loops, sampling and the continuous-batching serving engine."""

from flash_attention_cute_tpu_torch.runtime.engine import ServingEngine
from flash_attention_cute_tpu_torch.runtime.generate import generate, greedy_generate, prefill
from flash_attention_cute_tpu_torch.runtime.sampling import sample_token

__all__ = ["ServingEngine", "generate", "greedy_generate", "prefill", "sample_token"]
