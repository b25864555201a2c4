"""Device resolution for the port's prover (counterpart of
ziren_tpu/stark/backend.py, minus its environment switch and compile cache).

The default is the GPU. A CUDA device runs the hand-written kernels; the
CPU, which a caller has to name, runs their plain PyTorch versions: that is
how the tests hold the port against the JAX package on a machine without a
GPU.
"""

from __future__ import annotations

import torch

from ..device import require_cuda


def resolve_device(device=None) -> torch.device:
    """None is the current CUDA device, and raises without one."""
    if device is None:
        return require_cuda()
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"ziren_tpu_torch: unsupported device {dev}")
    return dev
