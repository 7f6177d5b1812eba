"""flash_attention_cute_tpu_torch: the PyTorch/CUDA port of
flash_attention_cute_tpu for NVIDIA Hopper (H100).

Same layout and public names as the JAX package: q [B, Hq, S, D], k/v
[B, Hkv, S, D], the stacked KV cache [L, B, Hkv, C, D], lengths [B] int32.
Attention kernels are CUDA C++ for sm_90a (csrc/), built with nvcc at first
use and bound through ctypes (ops/_build.py). Each kernel wrapper routes on
the device of its tensors: CPU tensors take the plain PyTorch version, CUDA
tensors the kernel. Entry points that create tensors default to
device="cuda".

    from flash_attention_cute_tpu_torch import flash_attn_func
    o = flash_attn_func(q, k, v, causal=True)
"""

from flash_attention_cute_tpu_torch.api import flash_attention_forward, flash_attn_func
from flash_attention_cute_tpu_torch.ops.reference import attention_reference

__version__ = "0.1.0"

__all__ = [
    "flash_attn_func",
    "flash_attention_forward",
    "attention_reference",
    "__version__",
]
