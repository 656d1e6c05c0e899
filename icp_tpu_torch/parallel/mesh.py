"""Process meshes for the sharded engines (port of
``icp_tpu/parallel/mesh.py``).

JAX's mesh is a grid of devices that one program drives; here it is a
``torch.distributed`` ``DeviceMesh`` over processes, one process a card
(NCCL) or a CPU process (gloo), named ``("points",)`` as JAX's 1-D mesh.
Every rank calls the sharded entry points with the same full inputs and
keeps its own equal slice of the padded rows (``shard_rows``), the
counterpart of JAX's ``points_sharding``; replicated values are plain
tensors every rank holds.

``make_mesh`` starts a world-1 group itself when no process group exists
(under ``torchrun``, the group of its environment), so one process runs
the sharded engines as JAX runs them on a one-device mesh.
``init_distributed`` is ``jax.distributed.initialize``'s counterpart.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

POINTS_AXIS = "points"
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _device_type(devices) -> str:
    """``"cuda"`` unless the caller asks for the CPU; without a card,
    ``None`` raises rather than moving to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices='cpu' to run "
                               "the sharded engines on the CPU (gloo)")
        return "cuda"
    kind = torch.device(devices).type
    if kind not in _BACKENDS:
        raise ValueError(f"sharded engines run on 'cuda' or 'cpu', not {kind!r}")
    return kind


def _local_rank(process_id: int | None) -> int:
    """This process's card: ``torchrun``'s ``LOCAL_RANK``, else its rank
    modulo the cards of the host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
    return rank % torch.cuda.device_count()


def check_backend(group, device_type: str) -> None:
    """Raise unless ``group``'s backend serves ``device_type`` tensors
    (NCCL for the card, gloo for the CPU)."""
    backend = str(dist.get_backend(group))
    if _BACKENDS[device_type] not in backend:
        raise ValueError(f"the process group's backend {backend!r} does not serve "
                         f"{device_type} tensors (needs {_BACKENDS[device_type]!r}); make the "
                         f"mesh with devices={device_type!r} in a process group of that backend")


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, *, devices=None) -> None:
    """Multi-process bring-up, one call a process before any mesh: a
    process group over ``tcp://coordinator_address`` with ``num_processes``
    ranks, this one ``process_id`` (NCCL on the card, gloo with
    ``devices="cpu"``), and on the card this process's device set to its
    local rank.  With no arguments the group is read from the environment
    (``torchrun``)."""
    kind = _device_type(devices)
    if kind == "cuda":
        torch.cuda.set_device(_local_rank(process_id))
    if coordinator_address is None:
        dist.init_process_group(_BACKENDS[kind], init_method="env://")
    else:
        dist.init_process_group(_BACKENDS[kind], init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)


def ensure_process_group(devices=None) -> str:
    """The device type of ``devices``, with a process group that serves it:
    the one that exists, else the environment's under ``torchrun``, else a
    world-1 group of this process alone."""
    kind = _device_type(devices)
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            init_distributed(devices=kind)
        else:
            if kind == "cuda":  # this process's card, chosen before the group
                torch.cuda.set_device(torch.cuda.current_device())
            dist.init_process_group(_BACKENDS[kind], store=dist.HashStore(), rank=0,
                                    world_size=1)
    check_backend(None, kind)
    return kind


def make_mesh(devices=None, axis: str = POINTS_AXIS) -> DeviceMesh:
    """1-D mesh named ``(axis,)`` over every rank of the process group, on
    the card unless ``devices`` is ``"cpu"``."""
    kind = ensure_process_group(devices)
    return init_device_mesh(kind, (dist.get_world_size(),), mesh_dim_names=(axis,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``, once its groups' backends are
    checked to serve it."""
    kind = mesh.device_type
    for name in mesh.mesh_dim_names:
        check_backend(mesh.get_group(name), kind)
    if kind == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(kind)


def pad_rows(x: torch.Tensor, mult: int, fill: float) -> torch.Tensor:
    """``x`` (N, ...) with rows of ``fill`` appended up to a multiple of
    ``mult``."""
    n_pad = -(-x.shape[0] // mult) * mult
    if n_pad == x.shape[0]:
        return x
    return torch.cat([x, torch.full((n_pad - x.shape[0],) + x.shape[1:], fill,
                                    dtype=x.dtype, device=x.device)])


def shard_rows(x: torch.Tensor, mesh: DeviceMesh, fill: float = 0.0,
               axis: str | None = None) -> torch.Tensor:
    """This rank's equal slice, along mesh axis ``axis`` (default: the
    first), of ``x``'s rows padded with ``fill`` to a multiple of the
    axis size."""
    axis = axis or mesh.mesh_dim_names[0]
    n_dev = mesh.size(mesh.mesh_dim_names.index(axis))
    padded = pad_rows(x, n_dev, fill)
    n_loc = padded.shape[0] // n_dev
    rank = mesh.get_local_rank(axis)
    return padded[rank * n_loc:(rank + 1) * n_loc]
