"""The port's hand-written CUDA kernels: build, bind and launch.

csrc/poseidon2.cu is compiled with nvcc for sm_90a into a shared library
with a plain C interface, loaded with ctypes. The build happens at first
use, into `ziren_tpu_torch/_build/`, cached by a hash of the sources and
flags. The Poseidon2 round constants come from the port's `core/poseidon2.py`
through a header generated into the build directory.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with torch.empty, launches on PyTorch's current stream without
synchronising, raises if the launch reports an error, and adds one to its
entry in `LAUNCHES` and to its shape's entry in `SHAPES`. There
is no fallback: callers route CPU tensors to the plain versions in
`ops/tposeidon2.py`, `ops/tpcs.py` and `ops/tchallenger.py` themselves.

Under a CUDA graph (stark/tfused.py) a wrapper runs once, at capture, and
launches nothing then: inside `recording()` its count goes to the capture's
histogram, and each replay adds that histogram to `LAUNCHES` and `SHAPES`
(`credit`), and to `REPLAYED`: `LAUNCHES` less `REPLAYED` is what the
wrappers launched themselves.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from .core import field as F
from .core import poseidon2 as hp2
from .ops import kplans

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("poseidon2.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The kernels read these two from the generated header. zt_permute spreads
# a state over 16 lanes up to this many states, and takes one thread a state
# above it.
PERMUTE_LANES_MAX_STATES = 8192
# K3 takes a level of at most this many digests (8 blocks of a cluster, 32
# digests each: ops/kplans.py); ops/tpcs.py splits a tree there.
LEVELS_MAX_HEIGHT = kplans.K3_HEIGHT_MAX

# launches per entry point since the last reset_launches(), and the same
# by shape: (n, w) for hash_rows, m for permute, (h, injected heights) for
# compress_levels, (n_in, nb_bits) for grind. Several host threads may
# launch at once (the recursion tree proves its lifts in a thread pool), so
# the counts change under a lock.
LAUNCHES = {"hash_rows": 0, "permute": 0, "compress_levels": 0, "grind": 0}
SHAPES: dict = {k: {} for k in LAUNCHES}
REPLAYED = dict.fromkeys(LAUNCHES, 0)  # the part of LAUNCHES that replays credited

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_LIB: list = []
_CAPTURE = threading.local()


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
            REPLAYED[k] = 0
            SHAPES[k].clear()


def _count(name: str, shape) -> None:
    hist = getattr(_CAPTURE, "hist", None)
    if hist is not None:  # captured into a graph: launched by its replays
        hist[name][shape] = hist[name].get(shape, 0) + 1
        return
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        SHAPES[name][shape] = SHAPES[name].get(shape, 0) + 1


@contextlib.contextmanager
def recording():
    """While a CUDA graph captures on this thread: the wrappers' counts go
    to the histogram yielded, {entry: {shape: count}}, and not to LAUNCHES."""
    hist = {k: {} for k in LAUNCHES}
    _CAPTURE.hist = hist
    try:
        yield hist
    finally:
        _CAPTURE.hist = None


def credit(hist: dict) -> None:
    """One replay of a graph whose capture recorded `hist`."""
    with _COUNT_LOCK:
        for name, shapes in hist.items():
            for shape, n in shapes.items():
                LAUNCHES[name] += n
                REPLAYED[name] += n
                SHAPES[name][shape] = SHAPES[name].get(shape, 0) + n


def constants_header() -> str:
    """C header of the Poseidon2 round constants as the kernels add them:
    Montgomery form (R = 2^32) minus p, int32 in [-p, 0). Twice: in constant
    memory for indices every thread shares, in global memory for indices
    that differ by lane. Then the internal diagonal in Montgomery form, in
    [0, p), and the two size limits above."""
    mont = (hp2.RC.astype(np.uint64) << np.uint64(32)) % np.uint64(F.P_INT)
    bias = mont.astype(np.int64) - F.P_INT
    rows = ",\n".join("  {" + ", ".join(str(int(v)) for v in row) + "}" for row in bias)
    dims = f"[{hp2.RC.shape[0]}][16]"
    diag = (hp2.INTERNAL_DIAG.astype(np.uint64) << np.uint64(32)) % np.uint64(F.P_INT)
    return (
        "// generated by ziren_tpu_torch/kernels.py from ziren_tpu_torch/core/poseidon2.py\n"
        "#pragma once\n#include <cstdint>\n"
        f"__constant__ int32_t ZT_RC_BIAS{dims} = {{\n{rows}\n}};\n"
        f"__device__ const int32_t ZT_RC_BIAS_G{dims} = {{\n{rows}\n}};\n"
        "__device__ const int32_t ZT_DIAG_MONT[16] = {"
        + ", ".join(str(int(v)) for v in diag) + "};\n"
        f"constexpr long long ZT_PERMUTE_LANES_MAX = {PERMUTE_LANES_MAX_STATES};\n"
        f"constexpr int ZT_LEVEL_MAX = {LEVELS_MAX_HEIGHT};\n"
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
    with open(lib_path + ".log", "w") as f:  # ptxas -v: registers, spills
        f.write(res.stderr)
    os.replace(tmp, lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    with _LOCK:
        if _LIB:
            return _LIB[0]
        path = _build(_nvcc())
        lib = ctypes.CDLL(path)
        lib.zt_path = path
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.zt_hash_rows.argtypes = [vp, vp, ll, ll, vp]
        lib.zt_hash_rows.restype = ctypes.c_int
        for fn in (lib.zt_permute, lib.zt_permute_lanes, lib.zt_permute_thread):
            fn.argtypes = [vp, vp, ll, vp]
            fn.restype = ctypes.c_int
        ci = ctypes.c_int
        lib.zt_compress_levels.argtypes = [vp, ctypes.POINTER(vp), vp, ci, ci, vp]
        lib.zt_compress_levels.restype = ci
        lib.zt_grind.argtypes = [vp, vp, ci, ci, vp, ci, ci, ci, vp]
        lib.zt_grind.restype = ci
        lib.zt_grind_occupancy.argtypes = [ctypes.POINTER(ci), ctypes.POINTER(ci)]
        lib.zt_grind_occupancy.restype = ci
        lib.zt_permute_latency.argtypes = [ci, ci, vp, vp, vp]
        lib.zt_permute_latency.restype = ci
        _LIB.append(lib)
        return lib


def build() -> float:
    """Build and load the kernels now; returns the seconds it took."""
    t0 = time.perf_counter()
    load()
    return time.perf_counter() - t0


def build_log() -> str:
    """What ptxas -v said of the loaded library (registers, spills)."""
    with open(load().zt_path + ".log") as f:
        return f.read()


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
    with torch.cuda.device(rows.device):
        out = torch.empty((n, 8), dtype=torch.int64, device=rows.device)
        if n:
            err = load().zt_hash_rows(
                ctypes.c_void_p(rows.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                n, w, _stream(rows),
            )
            _raise_on(err, "hash_rows")
            _count("hash_rows", (n, w))
    return out


def _permute(entry: str, states: torch.Tensor) -> torch.Tensor:
    _check(states, "permute", width=16)
    m = states.shape[0]
    with torch.cuda.device(states.device):
        out = torch.empty_like(states)
        if m:
            err = getattr(load(), entry)(
                ctypes.c_void_p(states.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                m, _stream(states),
            )
            _raise_on(err, "permute")
            _count("permute", m)
    return out


def permute(states: torch.Tensor) -> torch.Tensor:
    """K2: Poseidon2 permutation of each state, (m, 16) -> (m, 16). The
    kernel chooses its variant by m."""
    return _permute("zt_permute", states)


def permute_variant(states: torch.Tensor, lanes: bool) -> torch.Tensor:
    """One of K2's two variants by name, whatever m would choose: 16 lanes a
    state, or one thread a state. For holding one against the other; the
    prover calls `permute`."""
    return _permute("zt_permute_lanes" if lanes else "zt_permute_thread", states)


def compress_levels(digests: torch.Tensor, injected: dict) -> list:
    """K3: the Merkle levels below `digests`, (h, 8) with h a power of two,
    2 <= h <= LEVELS_MAX_HEIGHT, down to the root, in one launch. `injected`
    maps a level's height h' < h to the (h', 8) digests compressed into it.
    Returns the levels [(h/2, 8), (h/4, 8), ..., (1, 8)] as views of one
    tensor. The cluster's size is ops/kplans.py:k3_blocks(h)."""
    return compress_levels_split(digests, injected, None)


def compress_levels_split(digests: torch.Tensor, injected: dict, blocks) -> list:
    """compress_levels over a cluster of `blocks` blocks (k3_blocks(h) if
    None), for holding one split against another; the prover calls
    compress_levels."""
    _check(digests, "compress_levels", width=8)
    h = digests.shape[0]
    plan = kplans.k3_plan(h, injected, blocks)
    # pointers[k]: the digests injected at height 2^k (csrc: INJ_LEVELS = 8)
    pointers = (ctypes.c_void_p * 8)()
    for hh, inj in injected.items():
        _check(inj, "compress_levels (injected)", width=8)
        if inj.shape[0] != hh or inj.device != digests.device:
            raise ValueError(f"compress_levels: bad injected level {hh}: {tuple(inj.shape)}")
        pointers[hh.bit_length() - 1] = inj.data_ptr()
    with torch.cuda.device(digests.device):
        out = torch.empty((h - 1, 8), dtype=torch.int64, device=digests.device)
        err = load().zt_compress_levels(
            ctypes.c_void_p(digests.data_ptr()), pointers,
            ctypes.c_void_p(out.data_ptr()), h, plan.blocks, _stream(digests),
        )
        _raise_on(err, "compress_levels")
        _count("compress_levels", (h, tuple(sorted(injected, reverse=True))))
    return split_levels(out, h)


_OCCUPANCY: dict = {}


def grind_occupancy(device: torch.device) -> tuple:
    """(blocks of K4 a multiprocessor holds at once, multiprocessors), from
    the occupancy calculator, read once a device."""
    key = torch.device(device)
    key = key.index if key.index is not None else torch.cuda.current_device()
    if key not in _OCCUPANCY:
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(key):
            err = load().zt_grind_occupancy(ctypes.byref(per_sm), ctypes.byref(sms))
        _raise_on(err, "grind (occupancy)")
        _OCCUPANCY[key] = (per_sm.value, sms.value)
    return _OCCUPANCY[key]


def grind(state: torch.Tensor, inputs: torch.Tensor, nb_bits: int) -> torch.Tensor:
    """K4: the smallest proof-of-work witness w >= 0 such that permuting
    [inputs, w, state[n_in + 1:]] gives a canonical word 7 with nb_bits low
    zero bits; state (16,), inputs (n_in,) with n_in < 8, both int64
    canonical on one device. Returns a 0-d int64 tensor on that device (p
    if no witness below p exists). Its scratch, the best witness and the
    search's claim counter (which counts from p), is made and filled with p
    on the current stream before the launch, so a CUDA graph's replay
    resets it too."""
    for x, what in ((state, "grind (state)"), (inputs, "grind (inputs)")):
        if not x.is_cuda:
            raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
        if x.dtype != torch.int64 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{what}: expected a contiguous int64 vector")
    n_in = inputs.shape[0]
    if state.shape[0] != 16 or n_in >= 8 or inputs.device != state.device:
        raise ValueError(f"grind: bad state {tuple(state.shape)} or inputs {tuple(inputs.shape)}")
    if not 0 <= nb_bits <= 31:
        raise ValueError(f"grind: bad nb_bits {nb_bits}")
    with torch.cuda.device(state.device):
        return grind_with(state, inputs, nb_bits,
                          kplans.k4_plan(nb_bits, grind_occupancy(state.device)))


def grind_with(state: torch.Tensor, inputs: torch.Tensor, nb_bits: int, plan) -> torch.Tensor:
    """grind on another plan's form, grid and chunk, for holding one against
    another (tools/kernel_bench.py); the prover calls grind."""
    n_in = inputs.shape[0]
    with torch.cuda.device(state.device):
        scratch = torch.full((plan.scratch,), F.P_INT, dtype=torch.int64, device=state.device)
        err = load().zt_grind(
            ctypes.c_void_p(state.data_ptr()),
            ctypes.c_void_p(inputs.data_ptr() if n_in else None),
            n_in, nb_bits, ctypes.c_void_p(scratch.data_ptr()), plan.grid, plan.chunk,
            int(plan.ordered), _stream(state),
        )
        _raise_on(err, "grind")
        _count("grind", (n_in, nb_bits))
    return scratch[0]


def permute_latency(form: int, n: int, device) -> torch.Tensor:
    """Launch a chain of n dependent permutations in one warp, in `form`
    (0: one thread a state; 1: 4 lanes a state; 2: 16 lanes a state with
    shuffles, K2's for small m; 3: 16 lanes with warp reductions, K3's).
    Returns a (1,) int64 tensor that receives the chain's
    clock64 cycles. A probe for tools/kernel_bench.py and chip_smoke.py's
    latency floor; the prover never calls it."""
    with torch.cuda.device(device):
        cycles = torch.zeros(1, dtype=torch.int64, device=device)
        sink = torch.empty(32, dtype=torch.int64, device=device)
        err = load().zt_permute_latency(form, n, ctypes.c_void_p(cycles.data_ptr()),
                                        ctypes.c_void_p(sink.data_ptr()),
                                        _stream(cycles))
        _raise_on(err, "permute_latency")
    return cycles


def split_levels(flat: torch.Tensor, h: int) -> list:
    """(h - 1, 8) -> [(h/2, 8), (h/4, 8), ..., (1, 8)] views."""
    levels, off = [], 0
    while h > 1:
        h //= 2
        levels.append(flat[off : off + h])
        off += h
    return levels
