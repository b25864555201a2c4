"""Check and time the Poseidon2 kernels on one GPU.

    python3 -m ziren_tpu_torch.tools.kernel_bench [--parent DIR] [--sass] [--quick]

Builds csrc/poseidon2.cu, prints what ptxas said (registers, spills), holds
every entry point bit-exact against its plain PyTorch version over regular
and ragged shapes (K2 in both variants, K3 with and without injected
levels), then times each at the main path's shapes with CUDA events against
the bound

    max(permutations * 1960 multiplies / 16.7e12 per s,
        (input + output bytes as int64) / 3.35e12 per s)

where a row of width w is ceil(w / 8) permutations, a state is one and a
proof-of-work grind (K4, chip_smoke.py phase 3) is witness + 1. K3 has a
second floor, its chain of dependent levels (k3_chain_floor): log2(h) times
one permutation's latency, K2's time at m = 1 less a launch's. An
input smaller than the 50 MB L2 is timed over rotating copies that exceed
it together. `--parent DIR` names an unpacked earlier tree of this
repository: its kernels are timed in a subprocess before and after this
tree's (parent, change, change, parent), so the two are compared on one
card in one run. `--sass` counts the SASS instructions of each kernel by
opcode with cuobjdump. Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from .. import kernels
from ..device import require_cuda
from ..ops import tposeidon2 as tp2

P = 2130706433
MULS_PER_PERM = 1960
INT32_MULS_PER_S = 16.7e12
BYTES_PER_S = 3.35e12
L2_BYTES = 50 << 20
HOLD_CYCLES = 30_000_000  # about 15 ms of a spinning kernel ahead of a timing

K1_SHAPES = [(1 << 17, 600), (1 << 17, 83), (1 << 17, 23), (1 << 17, 8), (1 << 17, 1)]
K2_SIZES = [1, 8, 64, 256, 1 << 10, 1 << 11, 1 << 12, 1 << 13, 1 << 14, 1 << 16]


def bound_ms(perms: int, nbytes: int) -> tuple:
    ops = perms * MULS_PER_PERM / INT32_MULS_PER_S * 1e3
    mem = nbytes / BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def k1_bound(n: int, w: int) -> tuple:
    return bound_ms(n * -(-w // 8), 8 * n * (w + 8))


def k2_bound(m: int) -> tuple:
    return bound_ms(m, 8 * m * 32)


def k3_bound(h: int, injected: dict) -> tuple:
    inj = sum(injected)
    return bound_ms(h - 1 + inj, 8 * 8 * (h + inj + h - 1))


def k3_chain_floor(h: int, perm_ms: float, launch: float) -> float:
    """K3's floor however wide it runs: its log2(h) levels each wait for the
    level below, and each takes at least one permutation's latency, K2's
    time at m = 1 (`perm_ms`) less a launch's (`launch`)."""
    return (h.bit_length() - 1) * max(perm_ms - launch, 0.0)


def launch_ms(dev) -> float:
    """Device ms of the least kernel (a one-word add) timed back to back as
    cuda_ms times a kernel: what a timed launch costs beside its work."""
    x = torch.zeros(1, dtype=torch.int64, device=dev)
    return cuda_ms(lambda t: t.add_(1), [x], 200)


def k4_bound(witness: int, n_in: int) -> tuple:
    """K4 permutes every candidate up to the witness: witness + 1 at least."""
    return bound_ms(witness + 1, 8 * (16 + n_in + 1))


def cuda_ms(fn, inputs: list, reps: int) -> float:
    """Mean device milliseconds of fn(x) over reps calls that rotate through
    `inputs`, after one warm-up call on each. The stream is first held busy
    for some milliseconds, so the host has enqueued every call before the
    first one starts: a launch of a few microseconds is then timed on the
    device, not by the rate at which the host can enqueue."""
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for i in range(reps):
        fn(inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_copies(x: torch.Tensor) -> list:
    """x and as many copies as make the set larger than the L2."""
    nbytes = max(x.numel() * x.element_size(), 1)
    k = min(max(1, -(-2 * L2_BYTES // nbytes)), 64)
    return [x] + [x.clone() for _ in range(k - 1)]


def rand(rng, dev, *shape) -> torch.Tensor:
    return torch.as_tensor(rng.integers(0, P, shape, dtype=np.int64), device=dev)


def injected_for(rng, dev, h: int, heights) -> dict:
    return {hh: rand(rng, dev, hh, 8) for hh in heights if hh < h}


def check(dev, quick: bool) -> int:
    """Every entry point against its plain version; returns the case count."""
    rng = np.random.default_rng(7)
    cases = 0

    def same(name, got, want):
        nonlocal cases
        torch.cuda.synchronize()
        assert got.shape == want.shape and torch.equal(got, want), name
        cases += 1

    edge = torch.tensor([0, 1, P - 1, P - 2, 2, (P + 1) // 2], device=dev)
    shapes = [(5, 0), (1, 1), (3, 7), (129, 8), (127, 9), (1000, 16), (1025, 17),
              (257, 23), (4099, 83), (2048, 129), (300, 600)]
    if not quick:
        shapes += K1_SHAPES + [((1 << 17) - 977, 83)]
    for n, w in shapes:
        x = rand(rng, dev, n, w)
        if w:
            x[0, :] = edge[torch.arange(w, device=dev) % 6]
        same(("hash_rows", n, w), kernels.hash_rows(x), tp2.hash_rows_plain(x))
    for m in [1, 2, 3, 8, 31, 33, 1 << 10, 4097] + ([] if quick else [1 << 16]):
        x = rand(rng, dev, m, 16)
        x[0] = edge[torch.arange(16, device=dev) % 6]
        want = tp2.permute_plain(x)
        same(("permute", m), kernels.permute(x), want)
        for lanes in (False, True):
            same(("permute", m, lanes), kernels.permute_variant(x, lanes), want)
    for h in [2, 4, 8, 64, 128, 256]:
        cur = rand(rng, dev, h, 8)
        for heights in ([], [1], [h // 2], [hh for hh in (1, 2, 16, 64, 128)]):
            inj = injected_for(rng, dev, h, heights)
            got = kernels.compress_levels(cur, inj)
            want = tp2.compress_levels_plain(cur, inj)
            assert len(got) == len(want)
            for g, wnt in zip(got, want):
                same(("compress_levels", h, tuple(inj)), g, wnt)
    return cases


def time_kernels(dev, quick: bool) -> dict:
    rng = np.random.default_rng(11)
    out: dict = {"hash_rows": {}, "permute": {}, "permute_thread": {},
                 "permute_lanes": {}, "compress_levels": {}}
    for n, w in K1_SHAPES[: 2 if quick else None]:
        xs = cold_copies(rand(rng, dev, n, w))
        out["hash_rows"][f"{n}x{w}"] = cuda_ms(kernels.hash_rows, xs, 10)
    for m in K2_SIZES:
        xs = cold_copies(rand(rng, dev, m, 16))
        out["permute"][str(m)] = cuda_ms(kernels.permute, xs, 50)
        out["permute_thread"][str(m)] = cuda_ms(
            lambda x: kernels.permute_variant(x, False), xs, 50)
        out["permute_lanes"][str(m)] = cuda_ms(
            lambda x: kernels.permute_variant(x, True), xs, 50)
    out["launch_ms"] = launch_ms(dev)
    for h in (256, 32):
        xs = cold_copies(rand(rng, dev, h, 8))
        for heights in ([], [128, 64, 8]):
            inj = injected_for(rng, dev, h, heights)
            key = f"{h}+{len(inj)}"
            out["compress_levels"][key] = cuda_ms(
                lambda x: kernels.compress_levels(x, inj), xs, 50)
            out["compress_levels"][key + " plain"] = cuda_ms(
                lambda x: tp2.compress_levels_plain(x, inj), xs, 3)
    return out


_PARENT_SNIPPET = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, ".")
from ziren_tpu_torch import kernels
dev = torch.device("cuda")
rng = np.random.default_rng(11)
def ms(fn, xs, reps):
    for x in xs: fn(x)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(30_000_000)
    a.record()
    for i in range(reps): fn(xs[i % len(xs)])
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / reps
def copies(x):
    k = min(max(1, -(-(100 << 20) // max(x.numel() * 8, 1))), 64)
    return [x] + [x.clone() for _ in range(k - 1)]
out = {"hash_rows": {}, "permute": {}}
for n, w in json.loads(sys.argv[1]):
    x = torch.as_tensor(rng.integers(0, 2130706433, (n, w), dtype=np.int64), device=dev)
    out["hash_rows"][f"{n}x{w}"] = ms(kernels.hash_rows, copies(x), 10)
for m in json.loads(sys.argv[2]):
    x = torch.as_tensor(rng.integers(0, 2130706433, (m, 16), dtype=np.int64), device=dev)
    out["permute"][str(m)] = ms(kernels.permute, copies(x), 50)
print(json.dumps(out))
"""


def time_parent(parent: str, quick: bool) -> dict:
    """The same timings of the kernels of the tree unpacked at `parent`."""
    res = subprocess.run(
        [sys.executable, "-c", _PARENT_SNIPPET,
         json.dumps(K1_SHAPES[: 2 if quick else None]), json.dumps(K2_SIZES)],
        cwd=parent, capture_output=True, text=True, timeout=900,
    )
    if res.returncode != 0:
        raise RuntimeError(f"parent timing failed:\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def sass_counts(text: str | None = None) -> dict:
    """SASS instruction counts of each kernel of the loaded library
    (cuobjdump -sass): by opcode, and the size of each loop body (a backward
    branch and its target), so that instructions a permutation can be added
    up as body size times trip count."""
    if text is None:
        lib = kernels.load().zt_path
        exe = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
        text = subprocess.run([exe, "-sass", lib], capture_output=True, text=True,
                              check=True, timeout=600).stdout
    out: dict = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        ops: collections.Counter = collections.Counter()
        loops = []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d\s+)?([A-Z][A-Z0-9_]*)"
                             r"[^;]*?(?:\s0x([0-9a-f]+))?\s*;", chunk):
            addr, op, target = int(m.group(1), 16), m.group(2), m.group(3)
            ops[op] += 1
            if op == "BRA" and target and int(target, 16) < addr:
                loops.append((addr - int(target, 16)) // 16 + 1)
        out[name] = {"instructions": sum(ops.values()), "loop_bodies": loops,
                     "by_opcode": dict(ops.most_common())}
    return out


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    dev = require_cuda()
    smi = card()
    print(smi, flush=True)
    print(f"built in {kernels.build():.2f} s", flush=True)
    print(kernels.build_log(), flush=True)
    result: dict = {"card": smi}
    if args.sass:
        result["sass"] = sass_counts()
        for name, c in result["sass"].items():
            print(name, c, flush=True)
    result["checked_cases"] = check(dev, args.quick)
    print(f"bit-exact in {result['checked_cases']} cases", flush=True)
    runs = []
    if args.parent:
        runs.append(("parent", time_parent(args.parent, args.quick)))
    runs.append(("change", time_kernels(dev, args.quick)))
    runs.append(("change", time_kernels(dev, args.quick)))
    if args.parent:
        runs.append(("parent", time_parent(args.parent, args.quick)))
    result["runs"] = runs
    for who, r in runs:
        print(who, json.dumps(r), flush=True)
    bounds = {"hash_rows": {f"{n}x{w}": k1_bound(n, w) for n, w in K1_SHAPES},
              "permute": {str(m): k2_bound(m) for m in K2_SIZES},
              "compress_levels": {f"{h}+0": k3_bound(h, {}) for h in (256, 32)}}
    change = [r for who, r in runs if who == "change"][-1]
    bounds["compress_levels_chain_floor"] = {
        f"{h}": k3_chain_floor(h, change["permute"]["1"], change["launch_ms"]) for h in (256, 32)}
    result["bound_ms"] = bounds
    print("bounds", json.dumps(bounds), flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
