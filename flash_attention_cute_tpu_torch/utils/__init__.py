"""Shared utilities: device timing."""

from flash_attention_cute_tpu_torch.utils.timing import cuda_time_ms, wall_time_s  # noqa: F401
