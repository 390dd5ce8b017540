"""The CUDA device: presence, float32 numerics and identity."""

from __future__ import annotations

import os
import subprocess

import torch


def require_cuda() -> torch.device:
    """This process's CUDA device; raises when PyTorch sees none.  A rank of
    a multi-process launch (``python -m torch.distributed.run`` sets
    ``LOCAL_RANK``) takes card ``LOCAL_RANK % device_count``, so ranks
    spread over the host's cards and share them when there are fewer cards
    than ranks; any other process takes card 0."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is false")
    local_rank = os.environ.get("LOCAL_RANK")
    index = int(local_rank) % torch.cuda.device_count() if local_rank is not None else 0
    return torch.device("cuda", index)


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card
    (:func:`require_cuda`).  Tests pass ``device="cpu"``."""
    return require_cuda() if device is None else torch.device(device)


def disable_tf32() -> None:
    """Full float32 in matmuls and convolutions (TF32 keeps ~3 digits), and
    float32 sums in bfloat16 matmuls: cuBLAS may otherwise reduce in
    bfloat16, where JAX accumulates in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def gpu_identity() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip()
