"""The mesh axes over ``torch.distributed`` ranks
(``multi_modal_gnn_tpu/parallel/mesh.py``).

JAX builds a ``("data",)`` mesh over the chips one controller sees; here
every rank is a process, started by ``python -m torch.distributed.run
--nproc-per-node N`` (or :func:`~multi_modal_gnn_tpu_torch.parallel.launch.run_ranks`),
which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``
and ``MASTER_ADDR`` / ``MASTER_PORT``.  :func:`init_axis` joins the
process group they describe and returns the :class:`DataAxis`, the port's
counterpart of JAX's ``axis_name``:

* **the card**: a rank computes on card ``LOCAL_RANK % device_count``
  (:func:`~multi_modal_gnn_tpu_torch.utils.device.require_cuda`);
  ``device="cpu"`` is the only way onto the CPU;
* **the backend**: NCCL when every rank of the host has a card of its own;
  gloo when ranks share a card (NCCL refuses two ranks on one device) or
  run on the CPU.  Gloo stages CUDA tensors through the host itself for
  the collectives the port issues (all-reduce, all-gather, broadcast); a
  build whose gloo refused one would raise.  The compute stays on the card
  either way.  The choice is logged;
* **the rank count**: ``train.num_devices`` 0 means the world size; any
  other value must equal it.

Without ``WORLD_SIZE`` a run has one rank (``DataAxis(0, 1)``), as JAX's
one-device mesh: every collective is the identity.

:func:`init_2d_axes` lays the ranks out as JAX's ``("data", "model")``
mesh (``make_2d_mesh`` reshapes the devices to ``(n // m, m)``): global
rank ``r`` has data index ``r // m`` and model index ``r % m``.  Its data
axis reduces over the ``n // m`` ranks that share a model index, its model
axis over the ``m`` ranks that share a data index, each in a process group
of its own; every rank creates every group, in one order, because
``dist.new_group`` is itself a collective.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DATA_AXIS = "data"


@dataclass(frozen=True)
class DataAxis:
    """This process's place on one mesh axis: index ``rank`` of the axis's
    ``size`` ranks, the ``backend``, and the process ``group`` its
    collectives run in (None: the default group, every rank of the launch:
    the 1-D data axis)."""

    rank: int = 0
    size: int = 1
    backend: str = ""
    group: Optional[object] = None

    @property
    def distributed(self) -> bool:
        return self.size > 1

    def __deepcopy__(self, memo):
        # immutable, and a process group does not copy: a model's copy
        # (Trainer.eval_model) shares its axis
        return self


class Mesh2D(NamedTuple):
    """A rank's three axes on the ``("data", "model")`` mesh: ``world`` is
    every rank of the launch (the default group)."""

    data: DataAxis
    model: DataAxis
    world: DataAxis


def world_from_env() -> Tuple[int, int]:
    """``(rank, world size)`` of the launch, ``(0, 1)`` without one."""
    if os.environ.get("WORLD_SIZE") is None:
        return 0, 1
    return int(os.environ.get("RANK", "0")), int(os.environ["WORLD_SIZE"])


def choose_backend(device: torch.device) -> str:
    """NCCL when every rank of this host has a card of its own, else gloo."""
    if device.type != "cuda":
        return "gloo"
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if local_ranks <= torch.cuda.device_count() else "gloo"


def _join(device: torch.device, rank: int, world: int) -> str:
    """Join the launch's process group (once per process); its backend."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(choose_backend(device), init_method="env://", rank=rank, world_size=world)
    elif dist.get_world_size() != world:
        raise ValueError(f"process group of {dist.get_world_size()} ranks, WORLD_SIZE says {world}")
    backend = dist.get_backend()
    if rank == 0:
        logger.info(
            "Process group: %d ranks, backend %s (%s)", world, backend,
            "a card each" if backend == "nccl" else ("ranks share a card" if device.type == "cuda" else "CPU"),
        )
    return backend


def init_axis(device: torch.device, num_devices: int = 0) -> DataAxis:
    """Join the launch's process group (once per process) and return this
    rank's :class:`DataAxis`.  ``num_devices`` is ``train.num_devices``."""
    rank, world = world_from_env()
    if num_devices and num_devices != world:
        raise ValueError(f"Requested {num_devices} devices, have {world}")
    if world == 1:
        logger.info("Data axis: one rank (WORLD_SIZE unset or 1): a one-device mesh")
        return DataAxis()
    return DataAxis(rank=rank, size=world, backend=_join(device, rank, world))


def init_2d_axes(device: torch.device, num_devices: int = 0, model_parallel: int = 2) -> Mesh2D:
    """Join the launch's process group and return this rank's axes on the
    ``(world // model_parallel, model_parallel)`` mesh (module docstring;
    JAX ``make_2d_mesh``).  ``num_devices`` is ``train.num_devices``."""
    rank, world = world_from_env()
    if num_devices and num_devices != world:
        raise ValueError(f"Requested {num_devices} devices, have {world}")
    m = int(model_parallel)
    if m < 1 or world % m:
        raise ValueError(f"{world} devices not divisible by model_parallel={m}")
    if world == 1:
        return Mesh2D(DataAxis(), DataAxis(), DataAxis())
    backend = _join(device, rank, world)
    d = world // m
    # every rank creates every group, in this order
    data_groups = [dist.new_group([i * m + j for i in range(d)]) for j in range(m)]
    model_groups = [dist.new_group([i * m + j for j in range(m)]) for i in range(d)]
    mesh = Mesh2D(
        data=DataAxis(rank // m, d, backend, data_groups[rank % m]),
        model=DataAxis(rank % m, m, backend, model_groups[rank // m]),
        world=DataAxis(rank, world, backend),
    )
    if rank == 0:
        logger.info("2-D mesh: %d data x %d model ranks", d, m)
    return mesh


def shutdown() -> None:
    """Leave the process group, where this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
