"""The 1-D data axis over ``torch.distributed`` ranks
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
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DATA_AXIS = "data"


@dataclass(frozen=True)
class DataAxis:
    """This process's place on the data axis: ``rank`` of ``size`` ranks in
    the default process group, and its ``backend``."""

    rank: int = 0
    size: int = 1
    backend: str = ""

    @property
    def distributed(self) -> bool:
        return self.size > 1


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


def init_axis(device: torch.device, num_devices: int = 0) -> DataAxis:
    """Join the launch's process group (once per process) and return this
    rank's :class:`DataAxis`.  ``num_devices`` is ``train.num_devices``."""
    rank, world = world_from_env()
    if num_devices and num_devices != world:
        raise ValueError(f"Requested {num_devices} devices, have {world}")
    if world == 1:
        logger.info("Data axis: one rank (WORLD_SIZE unset or 1): a one-device mesh")
        return DataAxis()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = choose_backend(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    elif dist.get_world_size() != world:
        raise ValueError(f"process group of {dist.get_world_size()} ranks, WORLD_SIZE says {world}")
    axis = DataAxis(rank=rank, size=world, backend=dist.get_backend())
    if rank == 0:
        logger.info(
            "Data axis: %d ranks, backend %s (%s)", world, axis.backend,
            "a card each" if axis.backend == "nccl" else ("ranks share a card" if device.type == "cuda" else "CPU"),
        )
    return axis


def shutdown() -> None:
    """Leave the process group, where this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
