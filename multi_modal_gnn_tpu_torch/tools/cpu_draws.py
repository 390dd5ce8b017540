"""Run the pipeline command line with the training step's random draws taken
from the CPU's generators and moved to the card.

    python -m multi_modal_gnn_tpu_torch.tools.cpu_draws --config conf/eicu_real.yaml --no-confirm [...]

The arguments are :mod:`multi_modal_gnn_tpu_torch.pipeline`'s.  On the card a
run draws its dropout masks from the CUDA generator and each epoch's
supervision mask from a CUDA generator of its seed; on the CPU both come from
CPU generators of the same seeds.  Here every ``F.dropout`` mask is drawn on
the CPU (``bernoulli_(1 - p)`` over the input's shape, divided by ``1 - p``,
as PyTorch's CPU dropout draws it, from the CPU generator that the trainer
seeds per step) and each supervision mask from a CPU generator of its seed,
then moved to the card.  So a card run sees the draws of the CPU run of its
seed, and all else stays the card's: a diagnostic of whether a run's course
comes from its random stream or from the card's arithmetic
(``tools/flagship_band.py --draws cpu``).  The fused pair-head kernels hash
their own dropout bits alike on both devices and are left as they are.
"""

from __future__ import annotations

import dataclasses
import runpy
import sys

import torch
from torch.nn import functional as F

from multi_modal_gnn_tpu_torch.training.masker import EdgeMasker


def _cpu_dropout(input: torch.Tensor, p: float = 0.5, training: bool = True, inplace: bool = False) -> torch.Tensor:
    if not training or p == 0.0:
        return input
    noise = torch.empty(input.shape, dtype=input.dtype).bernoulli_(1.0 - p).div_(1.0 - p)
    return input * noise.to(input.device)


def install() -> None:
    """Patch ``F.dropout`` and ``EdgeMasker.supervision_mask`` in this process."""
    card_mask = EdgeMasker.supervision_mask

    def cpu_mask(self, epoch, batch=None, cluster=None):
        batch = batch if batch is not None else self.get_split("train")
        cpu = dataclasses.replace(batch, valid=batch.valid.cpu())
        return card_mask(self, epoch, cpu, cluster).to(batch.valid.device)

    F.dropout = _cpu_dropout
    EdgeMasker.supervision_mask = cpu_mask


def main() -> None:
    install()
    sys.argv = ["multi_modal_gnn_tpu_torch.pipeline", *sys.argv[1:]]
    runpy.run_module("multi_modal_gnn_tpu_torch.pipeline", run_name="__main__", alter_sys=True)


if __name__ == "__main__":
    main()
