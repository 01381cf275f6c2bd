"""The device mesh of multi-GPU training, the multi-process bring-up and
the ambient mesh of a step.

Counterpart of `smb_vision_tpu/parallel/mesh.py`. The port runs one
process a device (a rank), started by `python -m torch.distributed.run`
(or any launcher that sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT). `create_mesh` lays the world out as a ("data", "model")
`DeviceMesh`:

- axis "data": the batch, and the parameters and optimizer state that
  "fsdp" shards;
- axis "model": tensor parallelism.

Ranks are numbered data-major: rank = data index * model + model index,
so the ranks of one model group are neighbours (one host's NVLink). dcn >
1 keeps the same shape, as the JAX function does on a host without slice
topology: the device order is all it would change.

`use_mesh` makes a mesh the ambient one of a step, as `jax.set_mesh` does:
the losses (`parallel/collectives.py`), the masks and the DropPath draws
read it to act on the global batch.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

logger = logging.getLogger(__name__)

_CURRENT = {"mesh": None}


def world_size() -> int:
    """Processes in the default group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def _device_type() -> str:
    """The device type of the default group's collectives."""
    backend = dist.get_backend() if dist.is_initialized() else "gloo"
    return "cuda" if "nccl" in str(backend) else "cpu"


def create_mesh(data: Optional[int] = None, model: int = 1, dcn: int = 1,
                device_type: Optional[str] = None):
    """A ("data", "model") DeviceMesh over the world; data defaults to
    world // model. Raises as the JAX function does when the shape does
    not cover the world. Without a process group (one process) a 1 x 1
    mesh is None: single-device training, as before."""
    n = world_size()
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if dcn > 1 and data % dcn:
        raise ValueError(f"data={data} not divisible by dcn={dcn}")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or _device_type(), (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh[axis].size()


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh[axis].get_local_rank()


def local_batch_slice(global_batch: int,
                      mesh_or_world: Union[int, object, None]) -> int:
    """The per-process share of a global batch: global_batch over the
    data axis (each rank of one model group feeds the same rows), or over
    `mesh_or_world` processes when given a count. Raises when the batch
    does not divide."""
    if isinstance(mesh_or_world, int):
        n = mesh_or_world
    else:
        n = axis_size(mesh_or_world, DATA_AXIS)
    n = max(n, 1)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not divide over "
                         f"{n} data-parallel processes")
    return global_batch // n


def init_batch_size() -> int:
    """Rows of a dummy batch for an init pass: the ambient mesh's data
    size, else 1 (the JAX function's rule; parameter shapes never depend
    on the batch)."""
    return axis_size(current_mesh(), DATA_AXIS)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make `mesh` (or None) the ambient mesh inside the block."""
    prev = _CURRENT["mesh"]
    _CURRENT["mesh"] = mesh
    try:
        yield mesh
    finally:
        _CURRENT["mesh"] = prev


def current_mesh():
    return _CURRENT["mesh"]


def data_share() -> Tuple[int, int]:
    """(data-axis size, this rank's index on it) of the ambient mesh;
    (1, 0) without one."""
    mesh = current_mesh()
    return axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS)


def _launcher_env() -> dict:
    keys = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    return {k: os.environ.get(k) for k in keys}


def maybe_initialize_distributed(enable: Optional[bool] = None,
                                 device: str = "cuda") -> bool:
    """Multi-process bring-up: initialise torch.distributed from a
    launcher's environment (`torch.distributed.run` sets RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR and MASTER_PORT). Returns True when a process
    group is up.

    enable=None detects a launcher (WORLD_SIZE > 1 with MASTER_ADDR, or
    RANK / LOCAL_RANK set); False skips; True forces. The backend is NCCL
    on a CUDA device and gloo only for device "cpu"; on CUDA the device is
    LOCAL_RANK's. A group already up (this function called twice, or one
    the caller made) is used as it is. When only guessed from an
    incomplete environment (no MASTER_ADDR / MASTER_PORT) of a single
    process, it warns and stays one process; forced, or with WORLD_SIZE >
    1, it raises: a launcher that started several processes never gets
    one process a rank that trains alone, nor a fallback to gloo or the
    CPU."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = _launcher_env()
    world = int(env["WORLD_SIZE"] or 1)
    auto = enable is None
    if auto:
        enable = bool((world > 1 and env["MASTER_ADDR"])
                      or env["RANK"] is not None
                      or env["LOCAL_RANK"] is not None)
    if not enable:
        return False
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT")
               if not env[k]]
    if missing:
        if auto and world <= 1:
            logger.warning("launcher variables found but %s unset: "
                           "continuing as one process", ", ".join(missing))
            return False
        raise RuntimeError(f"multi-process training needs {missing} (start "
                           "it with python -m torch.distributed.run)")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {device} with WORLD_SIZE={world} but CUDA is not "
                "available: NCCL needs a GPU a rank (pass --device cpu for "
                "gloo on the CPU)")
        torch.cuda.set_device(int(env["LOCAL_RANK"] or 0))
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device {device!r}: expected cuda or cpu")
    dist.init_process_group(backend, init_method="env://",
                            world_size=world, rank=int(env["RANK"] or 0),
                            timeout=datetime.timedelta(minutes=30))
    logger.info("torch.distributed up: rank %d of %d, backend %s",
                dist.get_rank(), dist.get_world_size(), backend)
    return True
