"""Device resolution for the port's prover (counterpart of
ziren_tpu/stark/backend.py, minus its environment switch and compile cache).

The caller names the device. A CUDA device runs the hand-written kernels;
the CPU runs their plain PyTorch versions, which is how the tests hold the
port against the JAX package on a machine without a card.
"""

from __future__ import annotations

import torch

from ziren_tpu_torch.device import require_cuda


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"ziren_tpu_torch: unsupported device {dev}")
    return dev
