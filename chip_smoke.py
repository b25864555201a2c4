"""Chip smoke test of the PyTorch / CUDA port (ziren_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. torch / CUDA versions and the card's name and power limit;
  2. build the hand-written kernels from ziren_tpu_torch/csrc/;
  3. K1 (Poseidon2 row sponge), K2 (Poseidon2 permutation, both variants)
     and K3 (the lower levels of a Merkle tree) against their plain PyTorch
     versions on the card, bit-exact, at every shape the main path launches
     them with (K1_SHAPES, K2_SIZES, K3_SHAPES below; phase 5 fails if its
     prove launches a shape that is not among them), and a subsample
     against the host numpy Poseidon2; kernel and plain times from CUDA
     events over inputs that exceed the L2, beside the bound
     (ziren_tpu_torch/tools/kernel_bench.py defines it);
  4. a dev-config MIPS fibonacci(30) shard proved by the port, byte-equal to
     the host prover's proof, and verified;
  5. the main path: fibonacci(58218) at the core config (log_blowup 1,
     84 queries, 16 PoW bits), shards of 2^16 - 64 cycles, proved through
     ziren_tpu_torch.stark.machine.prove and checked by verify_mips_proof,
     with the kernels' launch counts and launch shapes from that run, then
     proved twice more for the spread of the rate.

The last two lines are the kernels' JSON record and the result line
{"ok": true, "device": {...}}. Without CUDA the script fails before any
result is printed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ziren_tpu_torch.device import require_cuda

KERNEL_SOURCE = "ziren_tpu_torch/csrc/poseidon2.cu"

# The shapes one fibonacci(58218) core-config prove launches each kernel
# with (its launch histogram, phase 5), and a few more. K1 (n, w): the trace,
# permutation, quotient and preprocessed matrices by height, the FRI layers
# (w = 8, every height down to 2), and the short chips (8 to 64 rows, up to
# 638 words); then ragged n, w < 8, w % 8 != 0 and a wide row at full height.
K1_SHAPES = [
    (131072, 108), (131072, 80), (131072, 20), (131072, 13),
    (32768, 46), (32768, 20),
    *[(1 << k, 8) for k in range(16, 0, -1)],
    (64, 46), (64, 16), (32, 14), (32, 4), (32, 1),
    (16, 66), (16, 48), (16, 24), (16, 14), (16, 12),
    (8, 638), (8, 300), (8, 104),
    (131072, 1), (131072, 7), (131072, 23), (131072, 83), (131072, 600), (131072 - 977, 83),
]
# K2 m: a duplex, the Merkle levels from 2^16 digests down to 256, the
# grind's batches of 2^14; 8 and 1,024 take the 16-lane variant, 2^16 the
# other.
K2_SIZES = [1, 8, *[1 << k for k in range(8, 17)]]
# K3 (h, injected heights): the trees of the traces hand over 256 digests
# and compress the short chips' digests in; a FRI tree of 256 leaves or
# fewer is one call with none.
K3_SHAPES = [(256, ()), (256, (64, 32, 16, 8)), (256, (128, 64, 8, 1)), (256, (32,)),
             *[(1 << k, ()) for k in range(7, 0, -1)], (16, (4,))]


def phase_kernels(dev) -> dict:
    """Every kernel entry against its plain version, bit-exact, at the main
    path's shapes, with its time, its bound and the plain version's time.
    Returns {entry: {"max_abs_err", "shapes": {shape: (ms, plain_ms, bound_ms,
    bound_by)}}}."""
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.core import poseidon2 as hp2
    from ziren_tpu_torch.ops import tfield as tf
    from ziren_tpu_torch.ops import tposeidon2 as tp2
    from ziren_tpu_torch.tools import kernel_bench as kb

    rng = np.random.default_rng(2026)
    rec = {}

    def note(name, shape, err, ms, plain_ms, bound):
        share = bound[0] / ms if ms else 0.0
        print(f"  {name} {shape}: bit-exact, kernel {ms:.4f} ms, bound {bound[0]:.3g} ms "
              f"({bound[1]}, {100 * share:.1f}% of the kernel's time), "
              f"plain {plain_ms:.3f} ms", flush=True)
        r = rec.setdefault(name, {"max_abs_err": 0, "shapes": {}})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["shapes"][shape] = (ms, plain_ms, *bound)

    def check(name, kernel, plain, host, x_np, reps, plain_reps, bound):
        x = tf.from_host(x_np, dev)
        got, want = kernel(x), plain(x)
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        assert err == 0 and torch.equal(got, want), (name, x_np.shape, err)
        sub = np.r_[0:64, x_np.shape[0] - 64 : x_np.shape[0]]
        sub = np.unique(sub[(sub >= 0) & (sub < x_np.shape[0])])
        host_out = host(x_np[sub])
        assert np.array_equal(tf.to_host(got[torch.as_tensor(sub, device=dev)]), host_out), name
        xs = kb.cold_copies(x)
        note(name, tuple(x_np.shape), err, kb.cuda_ms(kernel, xs, reps),
             kb.cuda_ms(plain, xs[:1], plain_reps), bound)

    def rand(n, w):
        return rng.integers(0, 2130706433, (n, w), dtype=np.uint32)

    for n, w in K1_SHAPES:
        big = n * w >= 1 << 20
        check("hash_rows", kernels.hash_rows, tp2.hash_rows_plain, hp2.hash_rows,
              rand(n, w), 10 if big else 30, 2, kb.k1_bound(n, w))
    for m in K2_SIZES:
        check("permute", kernels.permute, tp2.permute_plain, hp2.permute,
              rand(m, 16), 50, 5, kb.k2_bound(m))
        x = tf.from_host(rand(m, 16), dev)
        assert torch.equal(kernels.permute_variant(x, True), kernels.permute_variant(x, False)), m
    for h, heights in K3_SHAPES:
        cur = tf.from_host(rand(h, 8), dev)
        inj = {hh: tf.from_host(rand(hh, 8), dev) for hh in heights}
        got = kernels.compress_levels(cur, inj)
        want = tp2.compress_levels_plain(cur, inj)
        torch.cuda.synchronize()
        assert len(got) == len(want) == h.bit_length() - 1
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        assert err == 0 and all(torch.equal(g, w) for g, w in zip(got, want)), (h, heights)
        xs = kb.cold_copies(cur)
        note("compress_levels", (h, heights), err,
             kb.cuda_ms(lambda x: kernels.compress_levels(x, inj), xs, 50),
             kb.cuda_ms(lambda x: tp2.compress_levels_plain(x, inj), xs[:1], 3),
             kb.k3_bound(h, inj))
    return rec


def phase_small_shard(dev) -> None:
    from ziren_tpu_torch.executor.asm import fibonacci_program
    from ziren_tpu_torch.machine.mips import execute, mips_machine
    from ziren_tpu_torch.stark.config import dev_config
    from ziren_tpu_torch.stark.proof import MachineProof
    from ziren_tpu_torch.stark.prover import prove_shard
    from ziren_tpu_torch.stark.serialize import serialize_shard_proof
    from ziren_tpu_torch.stark import tprover

    program = fibonacci_program(30)
    machine = mips_machine(dev_config())
    pk, vk = machine.setup(program)
    _ex, record = execute(program)
    base = machine.config.challenger()
    pk.vk.observe_into(base)
    host = prove_shard(machine, pk, record, base.clone())
    t0 = time.perf_counter()
    port = tprover.prove_shard(machine, pk, record, base.clone(), dev)
    dt = time.perf_counter() - t0
    assert serialize_shard_proof(port) == serialize_shard_proof(host), \
        "port proof differs from the host prover's"
    assert machine.verify(vk, MachineProof([port]))
    print(f"  fibonacci(30) dev-config shard: byte-identical to the host proof, "
          f"verified ({dt:.2f} s on the port)", flush=True)


def phase_main_path(dev) -> dict:
    from ziren_tpu_torch.executor.asm import fibonacci_program
    from ziren_tpu_torch.machine.mips import execute_sharded, mips_machine, verify_mips_proof
    from ziren_tpu_torch.stark.config import core_config
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.stark.machine import prove

    n, shard_size = 58218, (1 << 16) - 64
    program = fibonacci_program(n)
    machine = mips_machine(core_config())
    t0 = time.perf_counter()
    pk, vk = machine.setup(program)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex, records = execute_sharded(program, shard_size)
    exec_s = time.perf_counter() - t0
    cycles = int(ex.global_clk)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    proof = prove(machine, pk, records, fix_shapes=True, stats=stats)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    shapes = {k: dict(v) for k, v in kernels.SHAPES.items()}
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    assert verify_mips_proof(machine, vk, proof, pc_start=program.pc_start)
    verify_s = time.perf_counter() - t0
    assert len(proof.shard_proofs) == len(records)
    for name, count in launches.items():
        assert count > 0, f"kernel {name} was not launched on the main path"

    print(f"  fibonacci({n}) core config: cycles {cycles}, shards {len(records)}, "
          f"setup {setup_s:.3f} s, execute {exec_s:.3f} s", flush=True)
    print(f"  prove {prove_s:.3f} s -> {cycles / prove_s / 1e3:.3f} kHz "
          f"(execute + prove {cycles / (exec_s + prove_s) / 1e3:.3f} kHz); "
          f"verify_mips_proof ok in {verify_s:.3f} s", flush=True)
    print("  per-shard dispatch s: "
          + ", ".join(f"{s:.3f}" for s in stats["dispatch_s"]), flush=True)
    print("  per-shard trace-gen wait s: "
          + ", ".join(f"{s:.3f}" for s in stats["trace_wait_s"])
          + f"; fetch {stats['fetch_s']:.3f} s, assemble {stats['assemble_s']:.3f} s",
          flush=True)
    print(f"  peak device memory allocated: {peak} bytes ({peak / 2**30:.3f} GiB)",
          flush=True)
    print(f"  kernel launches on the main path: {launches}", flush=True)
    for name, hist in shapes.items():
        print(f"  {name} launches by shape: "
              + ", ".join(f"{k}: {v}" for k, v in sorted(hist.items(), key=str)), flush=True)
    # phase 3 held every kernel at every shape this prove launched it with
    held = {"hash_rows": set(K1_SHAPES), "permute": set(K2_SIZES),
            "compress_levels": set(K3_SHAPES)}
    missed = {name: sorted(set(hist) - held[name], key=str) for name, hist in shapes.items()}
    assert not any(missed.values()), f"launched at shapes phase 3 did not hold: {missed}"
    rates = [cycles / prove_s / 1e3]
    for _ in range(2):  # the spread of the rate, on the same card
        _ex2, again = execute_sharded(program, shard_size)
        t0 = time.perf_counter()
        prove(machine, pk, again, fix_shapes=True)
        torch.cuda.synchronize()
        rates.append(cycles / (time.perf_counter() - t0) / 1e3)
    print("  prove-only kHz of three proves: "
          + ", ".join(f"{r:.3f}" for r in rates), flush=True)
    return launches


def main() -> None:
    dev = require_cuda()
    print("phase 1: environment", flush=True)
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)

    from ziren_tpu_torch import kernels

    print("phase 2: build", flush=True)
    print(f"  kernels built and loaded in {kernels.build():.3f} s", flush=True)
    for line in kernels.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip(), flush=True)

    print("phase 3: kernels vs plain PyTorch on the card", flush=True)
    rec = phase_kernels(dev)

    print("phase 4: small shard, port vs host prover", flush=True)
    phase_small_shard(dev)

    print("phase 5: main path", flush=True)
    launches = phase_main_path(dev)

    def entry(name, replaces, shape):
        # library_ms: no PyTorch call computes Poseidon2 or a Merkle level
        r = rec[name]
        ms, plain_ms, bound_ms, bound_by = r["shapes"][shape]
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": r["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                "shape": str(shape)}

    print(json.dumps({"kernels": [
        entry("hash_rows", "ziren_tpu/ops/jposeidon2.py:235", (1 << 17, 108)),
        entry("permute", "ziren_tpu/ops/jposeidon2.py:97", (1 << 16, 16)),
        entry("compress_levels", "ziren_tpu/ops/jpcs.py:173", (256, ())),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
