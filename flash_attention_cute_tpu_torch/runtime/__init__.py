"""Generation loops, sampling, speculative decoding and the continuous-
batching serving engine."""

from flash_attention_cute_tpu_torch.runtime.engine import ServingEngine
from flash_attention_cute_tpu_torch.runtime.generate import generate, greedy_generate, prefill
from flash_attention_cute_tpu_torch.runtime.prompt_lookup import prompt_lookup_generate
from flash_attention_cute_tpu_torch.runtime.sampling import sample_token
from flash_attention_cute_tpu_torch.runtime.speculative import speculative_generate

__all__ = ["ServingEngine", "generate", "greedy_generate", "prefill", "prompt_lookup_generate",
           "sample_token", "speculative_generate"]
