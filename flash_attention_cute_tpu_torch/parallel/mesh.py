"""Device mesh construction over torch.distributed.

Port of flash_attention_cute_tpu/parallel/mesh.py. A JAX mesh is an array
of devices that one process drives; a torch `DeviceMesh` is an array of the
group's ranks, each a process that drives its own card (or the CPU, over
gloo), built collectively: every rank calls `make_mesh` with the same
arguments.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(
    data: int | None = None,
    model: int | None = None,
    devices=None,
) -> DeviceMesh:
    """Build a ("data", "model") mesh over the ranks of the default group.

    Defaults: every rank on the model axis (tensor parallelism first, as
    the JAX package's). `devices`: the ranks to lay out, in order (default:
    all of them); the mesh holds CUDA cards under NCCL, the CPU otherwise.
    """
    devices = list(devices) if devices is not None else list(range(dist.get_world_size()))
    n = len(devices)
    if data is None and model is None:
        data, model = 1, n
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"a {data} x {model} mesh does not hold {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(devices).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def init_distributed(**kwargs) -> None:
    """`torch.distributed.init_process_group`, idempotent: NCCL where a
    CUDA card is visible, gloo otherwise, unless `backend` says. Nothing
    tells a program of a cluster here: pass `init_method` (such as
    "tcp://localhost:<port>"), `world_size` and `rank`, or set the `env://`
    variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)."""
    if dist.is_initialized():
        return
    kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(**kwargs)


def host_local_mesh_info(mesh: DeviceMesh) -> dict:
    """Which mesh coordinates this process owns (debug/observability): a
    rank drives one mesh entry, so at most one coordinate."""
    coord = mesh.get_coordinate()
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_coords": [tuple(int(c) for c in coord)] if coord is not None else [],
    }
