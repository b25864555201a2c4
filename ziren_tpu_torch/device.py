"""The port's CUDA check: the card's entry points have no silent CPU path."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The current CUDA device; raises when PyTorch sees no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("ziren_tpu_torch: CUDA is not available")
    return torch.device("cuda", torch.cuda.current_device())
