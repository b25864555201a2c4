"""The port's hand-written CUDA kernels: build, bind and launch.

csrc/poseidon2.cu is compiled with nvcc for sm_90a into a shared library
with a plain C interface, loaded with ctypes. The build happens at first
use, into `ziren_tpu_torch/_build/`, cached by a hash of the sources and
flags. The Poseidon2 round constants come from `ziren_tpu.core.poseidon2`
through a header generated into the build directory.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with torch.empty, launches on PyTorch's current stream without
synchronising, raises if the launch reports an error, and adds one to its
entry in `LAUNCHES`. There is no fallback: callers route CPU tensors to the
plain versions in `ops/tposeidon2.py` themselves.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from ziren_tpu.core import field as F
from ziren_tpu.core import poseidon2 as hp2

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("poseidon2.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# launches per entry point since the last reset_launches()
LAUNCHES = {"hash_rows": 0, "permute": 0}

_LOCK = threading.Lock()
_LIB: list = []


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def constants_header() -> str:
    """C header of the Poseidon2 constants in Montgomery form (R = 2^32)."""
    mont = lambda a: (a.astype(np.uint64) << np.uint64(32)) % np.uint64(F.P_INT)
    rows = ",\n".join(
        "  {" + ", ".join(f"{int(v)}u" for v in row) + "}" for row in mont(hp2.RC)
    )
    diag = ", ".join(f"{int(v)}u" for v in mont(hp2.INTERNAL_DIAG))
    return (
        "// generated by ziren_tpu_torch/kernels.py from ziren_tpu/core/poseidon2.py\n"
        "#pragma once\n#include <cstdint>\n"
        f"__constant__ uint32_t ZT_RC_MONT[{hp2.RC.shape[0]}][16] = {{\n{rows}\n}};\n"
        f"__constant__ uint32_t ZT_DIAG_MONT[16] = {{{diag}}};\n"
    )


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("ziren_tpu_torch: nvcc not found (set CUDA_HOME)")


def _build(nvcc: str) -> str:
    header = constants_header()
    h = hashlib.sha256(header.encode())
    h.update(repr(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    key = h.hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"libzt_kernels_{key}.so")
    if os.path.exists(lib_path):
        return lib_path
    inc = os.path.join(BUILD_DIR, f"include_{key}")
    os.makedirs(inc, exist_ok=True)
    with open(os.path.join(inc, "poseidon2_constants.h"), "w") as f:
        f.write(header)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-I", inc, "-o", tmp,
           *[os.path.join(CSRC, s) for s in SOURCES]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr[-4000:]}"
        )
    os.replace(tmp, lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    with _LOCK:
        if _LIB:
            return _LIB[0]
        lib = ctypes.CDLL(_build(_nvcc()))
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.zt_hash_rows.argtypes = [vp, vp, ll, ll, vp]
        lib.zt_hash_rows.restype = ctypes.c_int
        lib.zt_permute.argtypes = [vp, vp, ll, vp]
        lib.zt_permute.restype = ctypes.c_int
        _LIB.append(lib)
        return lib


def build() -> float:
    """Build and load the kernels now; returns the seconds it took."""
    t0 = time.perf_counter()
    load()
    return time.perf_counter() - t0


def _check(x: torch.Tensor, what: str, width: int | None = None) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.int64:
        raise ValueError(f"{what}: expected int64, got {x.dtype}")
    if x.dim() != 2 or (width is not None and x.shape[1] != width):
        raise ValueError(f"{what}: bad shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")


def _stream(x: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """K1: Poseidon2 sponge over each row, (n, w) int64 -> (n, 8) int64."""
    _check(rows, "hash_rows")
    n, w = rows.shape
    out = torch.empty((n, 8), dtype=torch.int64, device=rows.device)
    if n:
        lib = load()
        err = lib.zt_hash_rows(
            ctypes.c_void_p(rows.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            n, w, _stream(rows),
        )
        _raise_on(err, "hash_rows")
        LAUNCHES["hash_rows"] += 1
    return out


def permute(states: torch.Tensor) -> torch.Tensor:
    """K2: Poseidon2 permutation of each state, (m, 16) -> (m, 16)."""
    _check(states, "permute", width=16)
    m = states.shape[0]
    out = torch.empty_like(states)
    if m:
        lib = load()
        err = lib.zt_permute(
            ctypes.c_void_p(states.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            m, _stream(states),
        )
        _raise_on(err, "permute")
        LAUNCHES["permute"] += 1
    return out
