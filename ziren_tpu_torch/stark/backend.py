"""Device resolution for the port's prover (counterpart of
ziren_tpu/stark/backend.py, minus its environment switch and compile cache).

The default is the GPU. A CUDA device runs the hand-written kernels; the
CPU, which a caller has to name, runs their plain PyTorch versions: that is
how the tests hold the port against the JAX package on a machine without a
GPU. `resolve_device` lives in ziren_tpu_torch/device.py beside the mesh.
"""

from __future__ import annotations

from ..device import resolve_device

__all__ = ["resolve_device"]
