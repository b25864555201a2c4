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
     proved twice more for the spread of the rate;
  6. ops/tmerkle.py and ops/tntt.py on the card against the host's
     core/merkle.py and core/ntt.py, bit-exact: leaf hashes and root of a
     seeded (2^17, 83) matrix, a fold of digest levels, a coset LDE;
  7. a small recursion shard: one dev-config lift of the fibonacci(30) shard
     proof, proved by the port on the card, byte-equal to the host prover's
     proof of the same record;
  8. the recursion path at full width: the first RECURSION_SHARDS shard
     proofs of phase 5's core-config proof are compressed on the card
     (mips_pipeline.compress: a lift each, then the join tree, under the
     registry of that tree's own vks in place of the full enumeration, which
     does not fit in this script's time) and the root is checked
     (verify_compressed for the whole execution, the recursion machine's
     verify and is_complete = 0 for a partial range), then shrunk under
     compressed_config() on the card
     (pipeline.shrink) and verified. Reports the seconds of every lift and
     join with their split, of the registry and of shrink, the machines'
     chips and heights, the kernels' launches and launch shapes on this path
     (each must be among those phase 3 held), and peak device memory.

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
# The recursion path (phase 8): a lift, join or shrink machine has ten chips,
# all preprocessed, from RecFriFold at 2^18-2^19 rows down to RecOutput at 4;
# K1 hashes the LDEs (twice or four times the rows) of the main, permutation,
# quotient and preprocessed matrices by height (RecPoseidon2: 368 + 34
# columns), and the FRI layers from 2^20 rows down.
K1_RECURSION_SHAPES = [
    (1048576, 56), (1048576, 25), (1048576, 15), (1048576, 8), (524288, 56), (524288, 25),
    (524288, 21), (524288, 20), (524288, 16), (524288, 15), (524288, 8), (524288, 7),
    (262144, 413), (262144, 176), (262144, 90), (262144, 44), (262144, 32), (262144, 26),
    (262144, 16), (262144, 13), (262144, 12), (262144, 8), (262144, 4), (131072, 416),
    (131072, 404), (131072, 184), (131072, 152), (131072, 98), (131072, 85), (131072, 40),
    (131072, 32), (131072, 8), (2048, 24), (2048, 20), (2048, 1), (512, 226), (512, 4),
    (512, 1), (32, 10), (16, 4), (16, 1), (8, 4), (8, 3), (8, 1),
]
# K2 m: a duplex, the Merkle levels from 2^16 digests down to 256, the
# grind's batches of 2^14; 8 and 1,024 take the 16-lane variant, 2^16 the
# other. The recursion path's trees are up to 2^20 leaves tall.
K2_SIZES = [1, 8, *[1 << k for k in range(8, 21)]]
# K3 (h, injected heights): the trees of the traces hand over 256 digests
# and compress the short chips' digests in; a FRI tree of 256 leaves or
# fewer is one call with none.
K3_SHAPES = [(256, ()), (256, (64, 32, 16, 8)), (256, (128, 64, 8, 1)), (256, (32,)),
             *[(1 << k, ()) for k in range(7, 0, -1)], (16, (4,)),
             (256, (32, 16)), (256, (8,))]
# How many of phase 5's six shard proofs phase 8 compresses: four make a
# tree of two layers (joins of lifts, a join of joins) in about a third of
# the time all six take.
RECURSION_SHARDS = 4


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

    for n, w in K1_SHAPES + K1_RECURSION_SHAPES:
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


def phase_small_shard(dev) -> tuple:
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
    return machine, vk, port


def launches_of(path: str) -> dict:
    """The kernels' counts since the last reset, read just after `path` ran.
    Fails if a kernel was not launched on it, or was launched at a shape
    that phase 3 did not hold."""
    from ziren_tpu_torch import kernels

    launches = dict(kernels.LAUNCHES)
    shapes = {k: dict(v) for k, v in kernels.SHAPES.items()}
    print(f"  kernel launches on {path}: {launches}", flush=True)
    for name, hist in shapes.items():
        print(f"  {name} launches by shape: "
              + ", ".join(f"{k}: {v}" for k, v in sorted(hist.items(), key=str)), flush=True)
    for name, count in launches.items():
        assert count > 0, f"kernel {name} was not launched on {path}"
    held = {"hash_rows": set(K1_SHAPES + K1_RECURSION_SHAPES), "permute": set(K2_SIZES),
            "compress_levels": set(K3_SHAPES)}
    missed = {name: sorted(set(hist) - held[name], key=str) for name, hist in shapes.items()}
    assert not any(missed.values()), f"launched at shapes phase 3 did not hold: {missed}"
    return launches


def phase_main_path(dev) -> tuple:
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
    launches = launches_of("the main path")
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    assert verify_mips_proof(machine, vk, proof, pc_start=program.pc_start)
    verify_s = time.perf_counter() - t0
    assert len(proof.shard_proofs) == len(records)

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
    rates = [cycles / prove_s / 1e3]
    for _ in range(2):  # the spread of the rate, on the same card
        _ex2, again = execute_sharded(program, shard_size)
        t0 = time.perf_counter()
        prove(machine, pk, again, fix_shapes=True)
        torch.cuda.synchronize()
        rates.append(cycles / (time.perf_counter() - t0) / 1e3)
    print("  prove-only kHz of three proves: "
          + ", ".join(f"{r:.3f}" for r in rates), flush=True)
    return launches, (program, machine, vk, proof)


def phase_merkle_ntt(dev) -> None:
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.core import field as F
    from ziren_tpu_torch.core import merkle as hmerkle
    from ziren_tpu_torch.core import ntt as hntt
    from ziren_tpu_torch.ops import tfield as tf
    from ziren_tpu_torch.ops import tmerkle, tntt

    rng = np.random.default_rng(83)
    m = rng.integers(0, F.P_INT, (1 << 17, 83), dtype=np.uint32)
    tree = hmerkle.commit([m])
    x = tf.from_host(m, dev)
    leaves = tmerkle.leaf_hashes(x)
    assert np.array_equal(tf.to_host(leaves), tree.levels[0])
    kernels.reset_launches()
    root = tmerkle.merkle_root(x)
    root_launches = dict(kernels.LAUNCHES)
    assert np.array_equal(tf.to_host(root), tree.root)
    assert np.array_equal(tf.to_host(tmerkle.compress_levels(leaves, 5)), tree.levels[5])
    assert np.array_equal(tf.to_host(tmerkle.compress_levels(leaves, 17)), tree.levels[17])
    print("  tmerkle: leaf hashes, root and level folds of a (131072, 83) matrix "
          f"equal the host tree's; merkle_root launched {root_launches}", flush=True)
    e = rng.integers(0, F.P_INT, (1 << 14, 16), dtype=np.uint32)
    evals = tntt.ntt(e)  # device=None: the GPU
    assert np.array_equal(evals, hntt.ntt(e))
    assert np.array_equal(tntt.intt(evals), e)
    assert np.array_equal(tntt.coset_lde(e, 1, F.GENERATOR), hntt.coset_lde(e, 1, F.GENERATOR))
    print("  tntt: ntt, intt and coset_lde of a (16384, 16) matrix equal the host's",
          flush=True)


def phase_small_recursion(machine, vk, shard_proof) -> None:
    from ziren_tpu_torch.recursion import mips_pipeline as mp
    from ziren_tpu_torch.stark.proof import MachineProof
    from ziren_tpu_torch.stark.serialize import serialize_shard_proof

    t0 = time.perf_counter()
    rm, rvk, on_card = mp.lift_shard(machine, vk, shard_proof)  # device=None: the GPU
    dt = time.perf_counter() - t0
    _rm, _rvk, on_host = mp.lift_shard(machine, vk, shard_proof, device="host")
    assert serialize_shard_proof(on_card) == serialize_shard_proof(on_host), \
        "the port's recursion proof differs from the host prover's"
    assert rm.verify(rvk, MachineProof([on_card]))
    print(f"  dev-config lift of the fibonacci(30) shard: byte-identical to the host "
          f"proof, verified ({dt:.2f} s on the port)", flush=True)


def phase_recursion(program, machine, vk, proof) -> dict:
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.recursion import mips_pipeline as mp
    from ziren_tpu_torch.recursion import pipeline as pl
    from ziren_tpu_torch.stark.config import compressed_config
    from ziren_tpu_torch.stark.proof import MachineProof
    from ziren_tpu_torch.tools import compress_bench as cb

    shards = proof.shard_proofs[:RECURSION_SHARDS]
    whole = len(shards) == len(proof.shard_proofs)
    config = machine.config
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with cb.instrument() as times:
        t0 = time.perf_counter()
        registry = cb.tree_registry(machine, vk, shards, config)
        t1 = time.perf_counter()
        rm, rvk, root = mp.compress(machine, vk, MachineProof(shards), config=config,
                                    registry=registry)  # device=None: the GPU
        t2 = time.perf_counter()
        sm, svk, sproof, _ = pl.shrink(rm, rvk, root, config=compressed_config())
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    registry_s, compress_s, shrink_s = t1 - t0, t2 - t1, t3 - t2
    launches = launches_of("the recursion path")
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    if whole:  # the root's vk is a member, its RPV carries the registry's root
        mp.verify_compressed(machine, vk, rm, rvk, root, pc_start=program.pc_start,
                             registry=registry)
    else:  # a partial range: a valid proof that does not attest the whole execution
        assert rm.verify(rvk, MachineProof([root]))
        registry.membership(rvk.commit)
        rpv = [int(v) for v in root.public_values]
        assert rpv[mp.RPV_IS_COMPLETE] == 0 and rpv[mp.RPV_START_SHARD] == 1
        assert rpv[mp.RPV_NEXT_SHARD] == 1 + len(shards)
        assert rpv[mp.RPV_VK : mp.RPV_VK + 8] == [int(v) for v in vk.commit]
        assert rpv[mp.RPV_VK_ROOT : mp.RPV_VK_ROOT + 8] == [int(v) for v in registry.root]
    assert sm.verify(svk, sproof)
    assert [int(v) for v in sproof.shard_proofs[0].public_values] == pl.lift_digest(rvk, root)
    verify_s = time.perf_counter() - t0
    assert len(times["lift"]) == len(shards) and len(times["join"]) == len(shards) - 1

    print(f"  {len(shards)} of {len(proof.shard_proofs)} core-config shard proofs: the "
          f"tree's registry {registry_s:.2f} s, compress {compress_s:.2f} s "
          f"({len(times['enum_lift'])} lifts and {len(times['enum_join'])} joins traced "
          f"without proving, in both), shrink "
          f"{shrink_s:.2f} s; the root ({'verify_compressed' if whole else 'a partial range'}) "
          f"and the shrink proof verified in {verify_s:.2f} s", flush=True)
    for kind in ("lift", "join", "shrink"):
        print(f"  {kind} s, total (split): " + cb.summary(times[kind]), flush=True)
        print(f"  last {kind}'s machine (chip, log2 height, width, preprocessed width): "
              f"{times[kind][-1]['machine']}", flush=True)
    print(f"  peak device memory allocated: {peak} bytes ({peak / 2**30:.3f} GiB)",
          flush=True)
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
    small = phase_small_shard(dev)

    print("phase 5: main path", flush=True)
    launches, main_path = phase_main_path(dev)

    print("phase 6: tmerkle and tntt vs the host", flush=True)
    phase_merkle_ntt(dev)

    print("phase 7: small recursion shard, port vs host prover", flush=True)
    phase_small_recursion(*small)

    print("phase 8: the recursion path", flush=True)
    recursion_launches = phase_recursion(*main_path)

    def entry(name, replaces, shape):
        # library_ms: no PyTorch call computes Poseidon2 or a Merkle level
        r = rec[name]
        ms, plain_ms, bound_ms, bound_by = r["shapes"][shape]
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": replaces,
                "launches": launches[name] + recursion_launches[name],
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
