"""The CUDA device: presence, float32 numerics and identity."""

from __future__ import annotations

import subprocess

import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises when PyTorch sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


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
