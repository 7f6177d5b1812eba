"""The Llama, Qwen2, Mistral and Gemma2 models on the port's attention ops,
with HF checkpoint conversion (models/convert.py) and the task heads
(models/heads.py)."""

from flash_attention_cute_tpu_torch.models.cache import KVCache
from flash_attention_cute_tpu_torch.models.config import ModelConfig
from flash_attention_cute_tpu_torch.models.gemma2 import gemma2_9b_config, gemma2_config_from_hf
from flash_attention_cute_tpu_torch.models.heads import (
    embedding_pooling_forward,
    question_answering_forward,
    sequence_classification_forward,
    token_classification_forward,
)
from flash_attention_cute_tpu_torch.models.llama import llama_config_from_hf
from flash_attention_cute_tpu_torch.models.mistral import mistral_config_from_hf
from flash_attention_cute_tpu_torch.models.qwen2 import qwen2_config_from_hf
from flash_attention_cute_tpu_torch.models.transformer import forward, init_params

__all__ = ["ModelConfig", "KVCache", "forward", "init_params", "gemma2_9b_config",
           "gemma2_config_from_hf", "llama_config_from_hf", "mistral_config_from_hf",
           "qwen2_config_from_hf", "question_answering_forward",
           "sequence_classification_forward", "token_classification_forward",
           "embedding_pooling_forward"]
