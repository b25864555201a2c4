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
     (each must be among those phase 3 held), and peak device memory;
  9. the service path, through the entry points a user calls: a
     ProverServer at the core config in this process (device left at its
     default, the GPU) and a NetworkProver pointed at it serve
     fibonacci(58218) in shards of 2^16 - 64 cycles: ready, setup, execute
     (the cycle count of phase 5), three proves in turn and two at once from
     two threads, each verified by the client's own ProverClient and
     byte-equal to an in-process machine.mips.prove_program of the same
     program (the SDK's setup observes the entry pc and its prove leaves the
     last shard at its own shape, so phase 5's proof, which does neither, is
     another proof); a second setup builds no second key; an unknown program
     id comes back as an error and the server goes on answering. Then the
     CLI in processes of their own (python3 -m ziren_tpu_torch vkey, prove,
     verify at the dev config on a hand-written guest ELF; the same prove in
     this process gives the file's bytes and that leg's launches), and
     ProverClient(config="dev") up the ladder on fibonacci(30):
     compressed_prove (its default registry, the full enumeration, fits at
     this size only), verify_compressed, shrink_prove, wrap_prove (the host
     prover under outer_dev_config()), verify_wrapped. Reports every
     request's seconds at the client and in the server's prove, the bytes of
     request and reply, the client's verify, the kernels' launches and
     launch shapes (each among those phase 3 held) and peak device memory.

The last two lines are the kernels' JSON record and the result line
{"ok": true, "device": {...}}. Without CUDA the script fails before any
result is printed.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import tempfile
import threading
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
             (256, (32, 16)), (256, (8,)), (256, (32, 16, 8))]
# The service path (phase 9). StarkMachine.prove as the SDK calls it leaves
# every shard at its own shape: the sixth shard of fibonacci(58218) is
# shorter than the five that phase 5 pads it to.
K1_SERVICE_SHAPES = [
    (131072, 28), (131072, 11), (65536, 97), (65536, 52), (65536, 12), (8192, 46), (8192, 20),
    (32, 47), (32, 24), (32, 12),
]
# The dev-config ladder (phase 9): lift, join and shrink machines of 8
# queries, from 2^16 rows down.
K1_LADDER_SHAPES = [
    (131072, 56), (131072, 28), (131072, 25), (131072, 15), (131072, 11), (65536, 100),
    (65536, 44), (65536, 41), (65536, 26), (65536, 24), (65536, 16), (32768, 3),
    (16384, 401), (16384, 144), (16384, 77), (16384, 28), (16384, 24), (16384, 16),
    (16384, 11), (8192, 393), (8192, 124), (8192, 61), (8192, 16), (512, 97), (512, 52),
    (512, 12), (64, 92), (64, 36),
]
# The CLI's guest (phase 9): sixteen words at the dev config, one shard whose
# chips are 8 to 256 rows tall beside the 2^16 rows of the memory and program
# tables; the tree of its traces takes five short chips' digests in.
K1_CLI_SHAPES = [
    (256, 75), (256, 44), (128, 22), (128, 4), (32, 84), (32, 44), (32, 20),
    (8, 601), (8, 284), (8, 96),
]
K3_CLI_SHAPES = [(256, (128, 64, 32, 16, 8))]
K1_ALL_SHAPES = list(dict.fromkeys(K1_SHAPES + K1_RECURSION_SHAPES + K1_SERVICE_SHAPES
                                   + K1_LADDER_SHAPES + K1_CLI_SHAPES))
FIB_N, SHARD_SIZE, FIB_CYCLES = 58218, (1 << 16) - 64, 349318
# How many of phase 5's six shard proofs phase 8 compresses: two make a
# tree of one join over two lifts, in about a fifth of the time all six
# take, so that the script with phase 9 stays near half its time limit.
# K1_RECURSION_SHAPES goes on holding the shapes of the six-shard tree.
RECURSION_SHARDS = 2


def minimal_elf(n: int = 10, vaddr: int = 0x10000) -> bytes:
    """A MIPS32 little-endian ET_EXEC file of one PT_LOAD segment (read and
    execute) holding sixteen hand-encoded words: fibonacci in registers, n
    turns of a loop, the result committed as public word 0, then the halt
    syscall. The guest file of the CLI legs, here and in the tests."""
    assert 0 < n < 0x8000
    words = [
        0x24080000 | n,  # addiu $t0, $zero, n
        0x24090000,      # addiu $t1, $zero, 0      a
        0x240A0001,      # addiu $t2, $zero, 1      b
        0x012A5821,      # loop: addu $t3, $t1, $t2
        0x25490000,      # addiu $t1, $t2, 0
        0x256A0000,      # addiu $t2, $t3, 0
        0x2508FFFF,      # addiu $t0, $t0, -1
        0x1D00FFFB,      # bgtz $t0, loop
        0x00000000,      # nop (the delay slot)
        0x24020010,      # addiu $v0, $zero, 0x10   COMMIT
        0x24040000,      # addiu $a0, $zero, 0      word 0
        0x25450000,      # addiu $a1, $t2, 0
        0x0000000C,      # syscall
        0x24020000,      # addiu $v0, $zero, 0      HALT
        0x24040000,      # addiu $a0, $zero, 0      exit code
        0x0000000C,      # syscall
    ]
    code = b"".join(struct.pack("<I", w) for w in words)
    ehdr = struct.pack("<16sHHIIIIIHHHHHH", b"\x7fELF\x01\x01\x01" + bytes(9), 2, 8, 1,
                       vaddr, 52, 0, 0x1000, 52, 32, 1, 40, 0, 0)
    phdr = struct.pack("<IIIIIIII", 1, 84, vaddr, vaddr, len(code), len(code), 5, 4)
    return ehdr + phdr + code


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

    for n, w in K1_ALL_SHAPES:
        big = n * w >= 1 << 20
        check("hash_rows", kernels.hash_rows, tp2.hash_rows_plain, hp2.hash_rows,
              rand(n, w), 10 if big else 30, 2, kb.k1_bound(n, w))
    for m in K2_SIZES:
        check("permute", kernels.permute, tp2.permute_plain, hp2.permute,
              rand(m, 16), 50, 5, kb.k2_bound(m))
        x = tf.from_host(rand(m, 16), dev)
        assert torch.equal(kernels.permute_variant(x, True), kernels.permute_variant(x, False)), m
    for h, heights in K3_SHAPES + K3_CLI_SHAPES:
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
    held = {"hash_rows": set(K1_ALL_SHAPES), "permute": set(K2_SIZES),
            "compress_levels": set(K3_SHAPES + K3_CLI_SHAPES)}
    missed = {name: sorted(set(hist) - held[name], key=str) for name, hist in shapes.items()}
    assert not any(missed.values()), f"launched at shapes phase 3 did not hold: {missed}"
    return launches


def phase_main_path(dev) -> tuple:
    from ziren_tpu_torch.executor.asm import fibonacci_program
    from ziren_tpu_torch.machine.mips import execute_sharded, mips_machine, verify_mips_proof
    from ziren_tpu_torch.stark.config import core_config
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.stark.machine import prove

    n, shard_size = FIB_N, SHARD_SIZE
    program = fibonacci_program(n)
    machine = mips_machine(core_config())
    t0 = time.perf_counter()
    pk, vk = machine.setup(program)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex, records = execute_sharded(program, shard_size)
    exec_s = time.perf_counter() - t0
    cycles = int(ex.global_clk)
    assert cycles == FIB_CYCLES

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


def phase_service() -> dict:
    """The service path. Returns the kernels' launches: the core-config
    requests', the CLI guest's and the dev-config ladder's, counted apart."""
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.executor.asm import fibonacci_program
    from ziren_tpu_torch.machine.mips import prove_program
    from ziren_tpu_torch.network import NetworkProver, ProverServer, wire
    from ziren_tpu_torch.network.client import NetworkProverError
    from ziren_tpu_torch.sdk import ProverClient
    from ziren_tpu_torch.stark.config import core_config, outer_dev_config
    from ziren_tpu_torch.stark.serialize import serialize_machine_proof

    program = fibonacci_program(FIB_N)
    t0 = time.perf_counter()
    _m, _pk, _vk, direct, ex = prove_program(program, config=core_config(),
                                             shard_size=SHARD_SIZE)  # device=None: the GPU
    want = serialize_machine_proof(direct)
    print(f"  in-process prove_program (setup, execute, prove): "
          f"{time.perf_counter() - t0:.3f} s, {len(direct.shard_proofs)} shards, "
          f"{len(want)} bytes of proof", flush=True)
    assert int(ex.global_clk) == FIB_CYCLES

    server = ProverServer(host="127.0.0.1", port=0, config="core")  # device=None: the GPU
    served_s, lock = [], threading.Lock()
    inner = server.service._client.prove

    def timed_prove(*args, **kw):  # the server's seconds in ProverClient.prove
        t0 = time.perf_counter()
        try:
            return inner(*args, **kw)
        finally:
            with lock:
                served_s.append(time.perf_counter() - t0)

    server.service._client.prove = timed_prove
    with server:
        prover = NetworkProver(server.endpoint, timeout=600.0, config="core")
        assert prover.ready()
        t0 = time.perf_counter()
        pk, vk = prover.setup(program)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _values, report = prover.execute(pk)
        execute_s = time.perf_counter() - t0
        assert report.total_instruction_count == FIB_CYCLES and report.exit_code == 0
        print(f"  ready; setup {setup_s:.3f} s (the server's key and the client's own vk); "
              f"execute {execute_s:.3f} s, {report.total_instruction_count} cycles", flush=True)

        def request(client):
            t0 = time.perf_counter()
            proof = client.prove(pk, shard_size=SHARD_SIZE, verify=False)
            t1 = time.perf_counter()
            assert client._local.verify(proof, vk)  # the client's own ProverClient
            return proof, t1 - t0, time.perf_counter() - t1

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # the earlier phases' cached keys
        kernels.reset_launches()
        singles = [request(prover) for _ in range(3)]
        for proof, _s, _v in singles:
            assert serialize_machine_proof(proof.proof) == want, \
                "a served proof differs from the in-process prove"
        req_bytes = len(wire.dumps({"program_id": pk.program_id, "stdin": None,
                                    "shard_size": SHARD_SIZE}))
        reply_bytes = len(wire.dumps({"ok": True, "result": {"proof": singles[0][0]}}))
        single_served = list(served_s)
        single_peak = torch.cuda.max_memory_allocated()

        pair: list = [None, None]

        def worker(i):
            pair[i] = request(NetworkProver(server.endpoint, timeout=600.0, config="core"))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        pair_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = launches_of("the service path")
        peak = torch.cuda.max_memory_allocated()
        assert all(pair), "a concurrent request failed"
        for proof, _s, _v in pair:
            assert serialize_machine_proof(proof.proof) == want, \
                "a proof served beside another differs from the in-process prove"

        pk2, _vk2 = prover.setup(program)
        assert pk2.program_id == pk.program_id and len(server.service._keys) == 1
        try:
            prover.prove(type(pk)("feed" * 16, vk), shard_size=SHARD_SIZE)
        except NetworkProverError as e:
            assert "unknown program id" in str(e)
        else:
            raise AssertionError("an unknown program id was served")
        assert prover.ready()

    print("  three ProveCore requests in turn, client s: "
          + ", ".join(f"{s:.3f}" for _p, s, _v in singles)
          + "; the server's prove s: " + ", ".join(f"{s:.3f}" for s in single_served)
          + "; the client's verify s: " + ", ".join(f"{v:.3f}" for _p, _s, v in singles),
          flush=True)
    print(f"  request {req_bytes} bytes, reply {reply_bytes} bytes on the wire; "
          f"every proof byte-equal to the in-process prove", flush=True)
    print("  two ProveCore requests at once, client s: "
          + ", ".join(f"{s:.3f}" for _p, s, _v in pair)
          + "; the server's prove s: " + ", ".join(f"{s:.3f}" for s in served_s[3:])
          + "; the client's verify s: " + ", ".join(f"{v:.3f}" for _p, _s, v in pair)
          + f"; both proved and verified in {pair_s:.3f} s", flush=True)
    print(f"  {FIB_CYCLES / 1e3 / (sum(s for _p, s, _v in singles) / 3):.3f} kHz a request in "
          f"turn, {2 * FIB_CYCLES / 1e3 / max(s for _p, s, _v in pair):.3f} kHz with two at "
          f"once (client seconds, verify left out)", flush=True)
    print("  a second setup built no second key; an unknown program id came back as an "
          "error and the server went on answering", flush=True)
    print(f"  peak device memory allocated: {peak} bytes ({peak / 2**30:.3f} GiB) with two "
          f"requests in flight, {single_peak} bytes with one; {held} bytes of them were "
          f"held when the path began (the earlier phases' keys)", flush=True)

    # the CLI, each command a process of its own, at the dev config on the card
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        elf, out = os.path.join(tmp, "fib.elf"), os.path.join(tmp, "proof.bin")
        with open(elf, "wb") as f:
            f.write(minimal_elf(10))

        def cli(*argv):
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-m", "ziren_tpu_torch", *argv], cwd=repo,
                                 env=env, capture_output=True, text=True, timeout=300)
            assert res.returncode == 0, (argv, res.stderr[-2000:])
            return res.stdout, time.perf_counter() - t0

        vkey, vkey_s = cli("vkey", elf, "--config", "dev")
        proved, prove_s = cli("prove", elf, "--config", "dev", "-o", out)
        verified, verify_s = cli("verify", elf, out, "--config", "dev")
        assert vkey.startswith("vk: ") and "1 shard(s)" in proved
        assert "committed: " + (89).to_bytes(4, "little").hex() in proved
        assert verified.startswith("verification: ok")
        dev = ProverClient(config="dev")  # device=None: the GPU
        with open(elf, "rb") as f:
            epk, evk = dev.setup(f.read())
        # the same guest and config in this process: the launches and launch
        # shapes of the CLI's prove, which its own process took with it
        kernels.reset_launches()
        in_process = dev.prove(epk)
        torch.cuda.synchronize()
        cli_launches = launches_of("the CLI's guest (ProverClient.prove in this process)")
        with open(out, "rb") as f:
            assert f.read() == serialize_machine_proof(in_process.proof), \
                "the CLI's proof file differs from ProverClient.prove"
    print(f"  python3 -m ziren_tpu_torch on a 16-word guest ELF, dev config, each a process: "
          f"vkey {vkey_s:.2f} s, prove {prove_s:.2f} s (the file byte-equal to "
          f"ProverClient.prove), verify {verify_s:.2f} s", flush=True)

    # the upper rungs of the ladder, dev config, one shard
    kernels.reset_launches()
    small = fibonacci_program(30)
    spk, svk = dev.setup(small)
    t0 = time.perf_counter()
    compressed = dev.compressed_prove(spk)
    t1 = time.perf_counter()
    dev.verify_compressed(compressed, svk)
    t2 = time.perf_counter()
    shrunk = dev.shrink_prove(compressed)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    ladder = launches_of("the dev-config ladder")
    wrapped = dev.wrap_prove(shrunk, outer=outer_dev_config())
    t4 = time.perf_counter()
    assert dev.verify_wrapped(wrapped, shrunk)
    t5 = time.perf_counter()
    back = wire.loads(wire.dumps({"ok": True, "result": {"compressed": compressed}}))
    dev.verify_compressed(back["result"]["compressed"], svk)  # a CompressedProve reply
    print(f"  ProverClient(config='dev') on fibonacci(30), one shard: compressed_prove "
          f"{t1 - t0:.2f} s (core prove, the full lift + join registry, one lift; it fits "
          f"at the dev config only: at the core config the registry does not fit in a "
          f"call), verify_compressed {t2 - t1:.2f} s, shrink_prove {t3 - t2:.2f} s, "
          f"wrap_prove {t4 - t3:.2f} s (the host prover, outer_dev_config()), "
          f"verify_wrapped {t5 - t4:.2f} s; Groth16 and Plonk are not run here",
          flush=True)
    return {k: (launches[k], cli_launches[k], ladder[k]) for k in launches}


def main() -> None:
    dev = require_cuda()
    started = time.perf_counter()
    seconds = {}

    def phase(n, title, fn, *args):
        print(f"phase {n}: {title}", flush=True)
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[n] = time.perf_counter() - t0
        return out

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

    rec = phase(3, "kernels vs plain PyTorch on the card", phase_kernels, dev)
    small = phase(4, "small shard, port vs host prover", phase_small_shard, dev)
    launches, main_path = phase(5, "main path", phase_main_path, dev)
    phase(6, "tmerkle and tntt vs the host", phase_merkle_ntt, dev)
    phase(7, "small recursion shard, port vs host prover", phase_small_recursion, *small)
    recursion_launches = phase(8, "the recursion path", phase_recursion, *main_path)
    service_launches = phase(9, "the service path", phase_service)
    print("seconds by phase (phase 2 is the build above): "
          + ", ".join(f"{n}: {s:.1f}" for n, s in sorted(seconds.items()))
          + f"; the whole script {time.perf_counter() - started:.1f}", flush=True)

    def entry(name, replaces, shape):
        # library_ms: no PyTorch call computes Poseidon2 or a Merkle level
        r = rec[name]
        ms, plain_ms, bound_ms, bound_by = r["shapes"][shape]
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": replaces,
                "launches": launches[name] + recursion_launches[name]
                + sum(service_launches[name]),
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
