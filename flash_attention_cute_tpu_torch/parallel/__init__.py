"""Multi-card parallelism over torch.distributed: the ("data", "model")
device mesh and sequence-parallel attention (all-gather and ring).

Port of flash_attention_cute_tpu/parallel (its `mesh.py` and
`sequence.py`; the parameter and cache shardings of its `sharding.py` are
not ported yet). Each function runs SPMD: every rank of the group calls it
with its own shard.
"""

from flash_attention_cute_tpu_torch.parallel.mesh import make_mesh
from flash_attention_cute_tpu_torch.parallel.sequence import (
    allgather_attention,
    ring_attention,
)

__all__ = ["make_mesh", "allgather_attention", "ring_attention"]
