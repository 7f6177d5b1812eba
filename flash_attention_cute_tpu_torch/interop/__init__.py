"""HuggingFace interop: patch HF attention onto the port's kernels.

The analog of the source paper's L4 patchers (`patch_llama`,
`patch_qwen2`, `attention_forward`); port of the JAX package's
`interop/`."""

from flash_attention_cute_tpu_torch.interop.torch_patch import (  # noqa: F401
    attention_forward,
    patch_llama,
    patch_qwen2,
)

__all__ = ["attention_forward", "patch_llama", "patch_qwen2"]
