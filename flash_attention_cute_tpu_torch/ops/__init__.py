"""Attention ops: CUDA kernels for Hopper and their plain PyTorch versions.

Layout throughout: q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D].
"""

from flash_attention_cute_tpu_torch.ops.flash_decode import flash_attention_decode
from flash_attention_cute_tpu_torch.ops.flash_fwd import flash_attention_fwd
from flash_attention_cute_tpu_torch.ops.reference import attention_reference

__all__ = ["attention_reference", "flash_attention_fwd", "flash_attention_decode"]
