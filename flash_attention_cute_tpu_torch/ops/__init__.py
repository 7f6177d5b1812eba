"""Attention ops: CUDA kernels for Hopper and their plain PyTorch versions.

Layout throughout: q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D].
"""

from flash_attention_cute_tpu_torch.ops import autodiff
from flash_attention_cute_tpu_torch.ops.flash_bwd import flash_attention_bwd
from flash_attention_cute_tpu_torch.ops.flash_chunked import flash_attention_chunked
from flash_attention_cute_tpu_torch.ops.flash_decode import flash_attention_decode
from flash_attention_cute_tpu_torch.ops.flash_fwd import flash_attention_fwd
from flash_attention_cute_tpu_torch.ops.flash_varlen import (
    flash_attention_packed,
    flash_attention_varlen,
)
from flash_attention_cute_tpu_torch.ops.paged_attention import paged_attention_decode
from flash_attention_cute_tpu_torch.ops.reference import attention_reference

__all__ = ["attention_reference", "autodiff", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_decode", "flash_attention_chunked", "flash_attention_packed",
           "flash_attention_varlen", "paged_attention_decode"]
