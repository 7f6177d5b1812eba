"""The Llama model on the port's attention ops."""

from flash_attention_cute_tpu_torch.models.cache import KVCache
from flash_attention_cute_tpu_torch.models.config import ModelConfig
from flash_attention_cute_tpu_torch.models.llama import llama_config_from_hf
from flash_attention_cute_tpu_torch.models.transformer import forward, init_params

__all__ = ["ModelConfig", "KVCache", "forward", "init_params", "llama_config_from_hf"]
