"""Chip smoke test of the PyTorch / CUDA port (ziren_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. torch / CUDA versions and the card's name and power limit;
  2. build the hand-written kernels from ziren_tpu_torch/csrc/;
  3. K1 (Poseidon2 row sponge) and K2 (Poseidon2 permutation) against their
     plain PyTorch versions on the card, bit-exact, at the main path's
     shapes, and a subsample against the host numpy Poseidon2; kernel and
     plain times from CUDA events;
  4. a dev-config MIPS fibonacci(30) shard proved by the port, byte-equal to
     the host prover's proof, and verified;
  5. the main path: fibonacci(58218) at the core config (log_blowup 1,
     84 queries, 16 PoW bits), shards of 2^16 - 64 cycles, proved through
     ziren_tpu_torch.stark.machine.prove and checked by verify_mips_proof,
     with the kernels' launch counts from that run.

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


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls, after one warmup."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(dev) -> dict:
    from ziren_tpu.core import poseidon2 as hp2
    from ziren_tpu_torch import kernels
    from ziren_tpu_torch.ops import tfield as tf
    from ziren_tpu_torch.ops import tposeidon2 as tp2

    rng = np.random.default_rng(2026)
    rec = {}

    def check(name, kernel, plain, host, x_np, reps, plain_reps):
        x = tf.from_host(x_np, dev)
        got, want = kernel(x), plain(x)
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        assert err == 0 and torch.equal(got, want), (name, x_np.shape, err)
        sub = np.r_[0:64, x_np.shape[0] - 64 : x_np.shape[0]]
        sub = sub[(sub >= 0) & (sub < x_np.shape[0])]
        host_out = host(x_np[sub])
        assert np.array_equal(tf.to_host(got[torch.as_tensor(sub, device=dev)]), host_out), name
        ms = cuda_ms(lambda: kernel(x), reps)
        plain_ms = cuda_ms(lambda: plain(x), plain_reps)
        print(f"  {name} {tuple(x_np.shape)}: bit-exact, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms", flush=True)
        r = rec.setdefault(name, {"max_abs_err": 0, "shapes": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["shapes"].append((tuple(x_np.shape), ms, plain_ms))

    def rand(n, w):
        return rng.integers(0, 2130706433, (n, w), dtype=np.uint32)

    for w in (1, 7, 8, 23, 83, 600):
        check("hash_rows", kernels.hash_rows, tp2.hash_rows_plain, hp2.hash_rows,
              rand(1 << 17, w), 10, 2)
    check("hash_rows", kernels.hash_rows, tp2.hash_rows_plain, hp2.hash_rows,
          rand((1 << 17) - 977, 83), 10, 2)
    for m in (1 << 16, 1):
        check("permute", kernels.permute, tp2.permute_plain, hp2.permute,
              rand(m, 16), 20, 5)
    return rec


def phase_small_shard(dev) -> None:
    from ziren_tpu.executor.asm import fibonacci_program
    from ziren_tpu.machine.mips import execute, mips_machine
    from ziren_tpu.stark.config import dev_config
    from ziren_tpu.stark.proof import MachineProof
    from ziren_tpu.stark.prover import prove_shard
    from ziren_tpu.stark.serialize import serialize_shard_proof
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
    from ziren_tpu.executor.asm import fibonacci_program
    from ziren_tpu.machine.mips import execute_sharded, mips_machine, verify_mips_proof
    from ziren_tpu.stark.config import core_config
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
    proof = prove(machine, pk, records, device=dev, fix_shapes=True, stats=stats)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
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

    print("phase 3: kernels vs plain PyTorch on the card", flush=True)
    rec = phase_kernels(dev)

    print("phase 4: small shard, port vs host prover", flush=True)
    phase_small_shard(dev)

    print("phase 5: main path", flush=True)
    launches = phase_main_path(dev)

    def entry(name, replaces, shape):
        r = rec[name]
        ms, plain_ms = next((m, p) for s, m, p in r["shapes"] if s == shape)
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": r["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                "shape": list(shape)}

    print(json.dumps({"kernels": [
        entry("hash_rows", "ziren_tpu/ops/jposeidon2.py:235", (1 << 17, 83)),
        entry("permute", "ziren_tpu/ops/jposeidon2.py:97", (1 << 16, 16)),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
