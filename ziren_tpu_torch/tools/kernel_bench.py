"""Check and time the Poseidon2 kernels on one GPU.

    python3 -m ziren_tpu_torch.tools.kernel_bench [--parent DIR] [--sass] [--quick]

Run it from the repository's root (it reads chip_smoke.K3_ALL_SHAPES).
Builds csrc/poseidon2.cu, prints what ptxas said (registers, spills), holds
every entry point bit-exact against its plain PyTorch version over regular
and ragged shapes (K2 in both variants, K3 on every cluster that splits a
level, with and without injected levels, K4 on the seeded transcripts of
K4_TRANSCRIPTS), then times each at the main path's shapes with CUDA events
against the bound

    max(permutations * 1960 multiplies / 16.7e12 per s,
        (input + output bytes as int64) / 3.35e12 per s)

where a row of width w is ceil(w / 8) permutations, a state is one and a
proof-of-work grind (K4) is witness + 1. K3's levels form a chain, so it
has a second floor, its latency floor (k3_latency_floor): log2(h) plus its
injected levels times one permutation's latency in K3's form (16 lanes,
warp reductions), taken on the card from a chain of dependent permutations
in one warp (clock64 cycles, and CUDA events over two chain lengths for the
milliseconds), plus one launch. The same probe gives the latency of the
other forms (one thread, 4 lanes, 16 lanes with shuffles). K3 is also timed on every cluster size that splits each height. An
input smaller than the 50 MB L2 is timed over rotating copies that exceed
it together. `--parent DIR` names an unpacked earlier tree of this
repository: its kernels are timed in a subprocess before and after this
tree's (parent, change, change, parent) on the same inputs (K1 and K2 at
their shapes, K3 at every shape of chip_smoke.K3_ALL_SHAPES, K4 at (4, 16)
on every transcript), so the two are compared on one card in one run.
`--sass` counts the SASS instructions of each kernel by opcode with
cuobjdump. Prints one JSON object as its last line.
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
from ..ops import tchallenger as tch
from ..ops import tposeidon2 as tp2

P = 2130706433
MULS_PER_PERM = 1960
INT32_MULS_PER_S = 16.7e12
BYTES_PER_S = 3.35e12
L2_BYTES = 50 << 20
HOLD_CYCLES = 30_000_000  # about 15 ms of a spinning kernel ahead of a timing

K1_SHAPES = [(1 << 17, 600), (1 << 17, 83), (1 << 17, 23), (1 << 17, 8), (1 << 17, 1)]
K2_SIZES = [1, 8, 64, 256, 1 << 10, 1 << 11, 1 << 12, 1 << 13, 1 << 14, 1 << 16]
# K4 at the main path's (n_in, nb_bits) = (4, 16): the seeds of transcripts
# (k4_transcript) whose witnesses lie below 2^10 (746, 773, 1,021), around
# 2^16 (51,092, 71,209, 51,165) and above 131,072 (268,509, 257,046,
# 183,059), found with the host challenger.
K4_TRANSCRIPTS = [258, 329, 387, 6, 7, 9, 4, 23, 25]
K4_MAIN = (4, 16)
K4_DEV_BITS = (4, 2)  # the dev configs' bits, timed on the first three transcripts
LATENCY_CHAIN = (64, 1088)  # chain lengths whose time difference gives the ms
# the forms of kernels.permute_latency, by number: one thread, 4 lanes, 16
# lanes with shuffles (K2's for small m), 16 lanes with warp reductions (K3's)
LATENCY_FORMS = ("thread", "quad", "lanes16", "redux")
K3_FORM = "redux"


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


def k3_latency_floor(h: int, n_injected: int, perm_ms: float, launch: float) -> float:
    """K3's floor however wide it runs: its log2(h) levels and its injected
    levels each wait for the last, and each takes at least one permutation's
    latency (`perm_ms`, K3's form's on the card), after one launch."""
    return (h.bit_length() - 1 + n_injected) * perm_ms + launch


def permute_latency(dev) -> dict:
    """Per form (LATENCY_FORMS): one permutation's
    latency in a chain of dependent ones in one warp, as clock64 cycles and
    as device ms (the event time of two chain lengths, differenced)."""
    from .. import kernels

    out = {}
    short, long = LATENCY_CHAIN
    for form, name in enumerate(LATENCY_FORMS):
        cycles = kernels.permute_latency(form, long, dev)
        torch.cuda.synchronize()
        ms = {n: cuda_ms(lambda _x, n=n: kernels.permute_latency(form, n, dev), [None], 5)
              for n in (short, long)}
        out[name] = {"cycles": int(cycles) / long, "ms": (ms[long] - ms[short]) / (long - short)}
    return out


def k4_transcript(seed: int, n_in: int = K4_MAIN[0]):
    """The host challenger of a seeded transcript: 24 + n_in random words
    observed, so that n_in wait in its input buffer."""
    from ..core.challenger import DuplexChallenger

    host = DuplexChallenger()
    host.observe_slice(np.random.default_rng(seed).integers(0, P, 24 + n_in, dtype=np.uint32))
    return host


def k4_inputs(host, dev) -> tuple:
    """(state, inputs) of a host challenger, as K4 takes them."""
    from ..ops.tchallenger import TChallenger

    tc = TChallenger.from_host(host.clone(), dev)
    return tc.state, tc._concat_buffer().contiguous()


def k3_inputs(dev, h: int, heights) -> tuple:
    """The seeded digests and injected digests K3 is timed on (the parent's
    snippet makes the same)."""
    rng = np.random.default_rng(1000 * h + sum(heights))
    return rand(rng, dev, h, 8), {hh: rand(rng, dev, hh, 8) for hh in heights}


def k3_shapes() -> list:
    from chip_smoke import K3_ALL_SHAPES

    return K3_ALL_SHAPES


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


def splits(h: int) -> list:
    """Every cluster size that can split h digests (ops/kplans.py)."""
    from ..ops import kplans

    out = []
    for blocks in (1, 2, 4, 8):
        try:
            kplans.k3_plan(h, (), blocks)
        except ValueError:
            continue
        out.append(blocks)
    return out


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
    for h in [2, 4, 8, 16, 64, 128, 256]:
        cur = rand(rng, dev, h, 8)
        for heights in ([], [1], [h // 2], [hh for hh in (1, 2, 4, 8, 16, 64, 128)]):
            inj = injected_for(rng, dev, h, heights)
            want = tp2.compress_levels_plain(cur, inj)
            for blocks in splits(h):
                got = kernels.compress_levels_split(cur, inj, blocks)
                assert len(got) == len(want)
                for g, wnt in zip(got, want):
                    same(("compress_levels", h, tuple(inj), blocks), g, wnt)
    for seed in K4_TRANSCRIPTS[: 3 if quick else None]:
        host = k4_transcript(seed)
        state, inputs = k4_inputs(host, dev)
        got = kernels.grind(state, inputs, K4_MAIN[1])
        same(("grind", seed), got, tch._grind(state, inputs, K4_MAIN[1], K4_MAIN[0]))
        assert int(got) == host.grind(K4_MAIN[1]), seed
    return cases


def time_kernels(dev, quick: bool) -> dict:
    rng = np.random.default_rng(11)
    out: dict = {"hash_rows": {}, "permute": {}, "permute_thread": {},
                 "permute_lanes": {}, "compress_levels": {}, "compress_levels_split": {},
                 "grind": {}}
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
    out["permute_latency"] = permute_latency(dev)
    for h, heights in k3_shapes():
        cur, inj = k3_inputs(dev, h, heights)
        xs = cold_copies(cur)
        key = f"{h} {list(heights)}"
        out["compress_levels"][key] = cuda_ms(lambda x: kernels.compress_levels(x, inj), xs, 50)
        if not heights:
            for blocks in splits(h):
                out["compress_levels_split"][f"{h} B={blocks}"] = cuda_ms(
                    lambda x: kernels.compress_levels_split(x, inj, blocks), xs, 50)
    for seed in K4_TRANSCRIPTS:
        state, inputs = k4_inputs(k4_transcript(seed), dev)
        out["grind"][str(seed)] = cuda_ms(
            lambda x: kernels.grind(x, inputs, K4_MAIN[1]), [state], 20)
        if seed in K4_TRANSCRIPTS[:3]:
            for bits in K4_DEV_BITS:
                out["grind"][f"{seed} {bits} bits"] = cuda_ms(
                    lambda x: kernels.grind(x, inputs, bits), [state], 20)
    out["grind_grid"] = grind_grids(dev)
    return out


def grind_grids(dev) -> dict:
    """K4 at (4, 16) on other grids (blocks a multiprocessor, up to what the
    card holds) and chunks, on every transcript: the trade between a smaller
    first wave and the rate of a full card. Keys "<grid> w=<witness>", and
    "<grid> mean" over the transcripts."""
    from ..ops import kplans

    per_sm, sms = kernels.grind_occupancy(dev)
    out = {"blocks_per_sm": per_sm, "sms": sms}
    plans = {f"{k}/SM": kplans.K4Plan(k * sms, kplans.K4_THREADS, kplans.K4_CHUNK,
                                      kplans.K4_SCRATCH)
             for k in range(1, per_sm + 1)}
    for chunk in (64, 128):
        plans[f"chunk {chunk}"] = kplans.K4Plan(kplans.K4_BLOCKS_PER_SM * sms, kplans.K4_THREADS,
                                                chunk, kplans.K4_SCRATCH)
    for seed in K4_TRANSCRIPTS:
        host = k4_transcript(seed)
        state, inputs = k4_inputs(host, dev)
        want = host.grind(K4_MAIN[1])  # the host's grind observes its witness
        for name, plan in plans.items():
            assert int(kernels.grind_with(state, inputs, K4_MAIN[1], plan)) == want, (name, seed)
            ms = cuda_ms(lambda x: kernels.grind_with(x, inputs, K4_MAIN[1], plan), [state], 20)
            out[f"{name} w={want}"] = ms
            out[f"{name} mean"] = out.get(f"{name} mean", 0.0) + ms / len(K4_TRANSCRIPTS)
    # the two forms at fewer bits (kplans.K4_STRIDE_MAX_BITS draws the line)
    for bits in (2, 4, 6, 8, 12):
        want = -(-(2 << bits) // kplans.K4_THREADS)
        forms = {"ordered": kplans.K4Plan(min(kplans.K4_BLOCKS_PER_SM * sms, want),
                                          kplans.K4_THREADS, kplans.K4_CHUNK, kplans.K4_SCRATCH),
                 "stride": kplans.K4Plan(min(per_sm * sms, want), kplans.K4_THREADS,
                                         kplans.K4_CHUNK, kplans.K4_SCRATCH, ordered=False)}
        for seed in K4_TRANSCRIPTS[:3]:
            host = k4_transcript(seed)
            state, inputs = k4_inputs(host, dev)
            want = host.grind(bits)
            for name, plan in forms.items():
                assert int(kernels.grind_with(state, inputs, bits, plan)) == want, (name, bits)
                out[f"{name} {bits} bits w={want}"] = cuda_ms(
                    lambda x: kernels.grind_with(x, inputs, bits, plan), [state], 20)
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
def rand(r, *shape):
    return torch.as_tensor(r.integers(0, 2130706433, shape, dtype=np.int64), device=dev)
args = json.loads(sys.argv[1])
out = {"hash_rows": {}, "permute": {}, "compress_levels": {}, "grind": {}}
for n, w in args["k1"]:
    out["hash_rows"][f"{n}x{w}"] = ms(kernels.hash_rows, copies(rand(rng, n, w)), 10)
for m in args["k2"]:
    out["permute"][str(m)] = ms(kernels.permute, copies(rand(rng, m, 16)), 50)
for h, heights in args["k3"]:
    r = np.random.default_rng(1000 * h + sum(heights))
    cur = rand(r, h, 8)
    inj = {hh: rand(r, hh, 8) for hh in heights}
    out["compress_levels"][f"{h} {list(heights)}"] = ms(
        lambda x: kernels.compress_levels(x, inj), copies(cur), 50)
for i, (seed, state, inputs) in enumerate(args["k4"]):
    st = torch.tensor(state, dtype=torch.int64, device=dev)
    inp = torch.tensor(inputs, dtype=torch.int64, device=dev)
    out["grind"][str(seed)] = ms(lambda x: kernels.grind(x, inp, args["bits"]), [st], 20)
    for bits in (args["dev_bits"] if i < 3 else []):
        out["grind"][f"{seed} {bits} bits"] = ms(lambda x: kernels.grind(x, inp, bits), [st], 20)
print(json.dumps(out))
"""


def time_parent(parent: str, quick: bool, dev) -> dict:
    """The same timings of the kernels of the tree unpacked at `parent`, on
    the same inputs."""
    k4 = []
    for seed in K4_TRANSCRIPTS:
        state, inputs = k4_inputs(k4_transcript(seed), dev)
        k4.append((seed, state.tolist(), inputs.tolist()))
    args = {"k1": K1_SHAPES[: 2 if quick else None], "k2": K2_SIZES,
            "k3": [(h, list(hh)) for h, hh in k3_shapes()], "k4": k4, "bits": K4_MAIN[1],
            "dev_bits": list(K4_DEV_BITS)}
    res = subprocess.run(
        [sys.executable, "-c", _PARENT_SNIPPET, json.dumps(args)],
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
        runs.append(("parent", time_parent(args.parent, args.quick, dev)))
    runs.append(("change", time_kernels(dev, args.quick)))
    runs.append(("change", time_kernels(dev, args.quick)))
    if args.parent:
        runs.append(("parent", time_parent(args.parent, args.quick, dev)))
    result["runs"] = runs
    for who, r in runs:
        print(who, json.dumps(r), flush=True)
    change = [r for who, r in runs if who == "change"][-1]
    perm_ms = change["permute_latency"][K3_FORM]["ms"]
    witnesses = {str(s): k4_transcript(s).grind(K4_MAIN[1]) for s in K4_TRANSCRIPTS}
    bounds = {"hash_rows": {f"{n}x{w}": k1_bound(n, w) for n, w in K1_SHAPES},
              "permute": {str(m): k2_bound(m) for m in K2_SIZES},
              "compress_levels": {f"{h} {list(hh)}": k3_bound(h, hh) for h, hh in k3_shapes()},
              "compress_levels_latency_floor": {
                  f"{h} {list(hh)}": k3_latency_floor(h, len(hh), perm_ms, change["launch_ms"])
                  for h, hh in k3_shapes()},
              "grind": {s: k4_bound(w, K4_MAIN[0]) for s, w in witnesses.items()}}
    result["bound_ms"] = bounds
    result["k4_witnesses"] = witnesses
    print("bounds", json.dumps(bounds), flush=True)
    print("K4 witnesses", json.dumps(witnesses), flush=True)
    summary(runs, bounds)
    print(json.dumps(result), flush=True)


def summary(runs: list, bounds: dict) -> None:
    """K3 and K4, parent and change, mean of each side's runs, beside the
    bounds: one line a shape."""
    def mean(who, kernel, key):
        vals = [r[kernel][key] for w, r in runs if w == who and key in r.get(kernel, {})]
        return sum(vals) / len(vals) if vals else float("nan")

    for key, bound in bounds["compress_levels"].items():
        floor = bounds["compress_levels_latency_floor"][key]
        new = mean("change", "compress_levels", key)
        print(f"K3 {key}: parent {mean('parent', 'compress_levels', key):.4f} ms, "
              f"change {new:.4f} ms; operations bound {bound[0]:.5f} ms "
              f"({100 * bound[0] / new:.2f}%), latency floor {floor:.4f} ms "
              f"({100 * floor / new:.1f}%)", flush=True)
    old, new, bnd = [], [], []
    for key, bound in bounds["grind"].items():
        old.append(mean("parent", "grind", key))
        new.append(mean("change", "grind", key))
        bnd.append(bound[0])
        print(f"K4 transcript {key}: parent {old[-1]:.4f} ms, change {new[-1]:.4f} ms, "
              f"bound {bound[0]:.4f} ms ({100 * bound[0] / new[-1]:.1f}%)", flush=True)
    print(f"K4 (4, 16) mean over {len(new)} transcripts: parent {sum(old) / len(old):.4f} ms, "
          f"change {sum(new) / len(new):.4f} ms, bound {sum(bnd) / len(bnd):.4f} ms", flush=True)
    for bits in K4_DEV_BITS:
        keys = [f"{s} {bits} bits" for s in K4_TRANSCRIPTS[:3]]
        print(f"K4 (4, {bits}) on {len(keys)} transcripts: parent "
              + ", ".join(f"{mean('parent', 'grind', k):.4f}" for k in keys) + " ms, change "
              + ", ".join(f"{mean('change', 'grind', k):.4f}" for k in keys) + " ms", flush=True)


if __name__ == "__main__":
    main()
