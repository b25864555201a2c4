"""Benchmark entry point of the port (counterpart of the JAX repo's
bench.py). Prints ONE JSON line:
    {"metric": "core_prove_khz", "value": N, "unit": "kHz", "vs_baseline": N, "detail": {...}}

    python -m ziren_tpu_torch.tools.bench

Metric: **core_prove_khz**, MIPS cycles proven per millisecond end to end
(execute + trace generation + commit + LogUp permutation + quotient + FRI
open, per shard), at the production core FRI config (log_blowup=1, 84
queries, 16 PoW bits). Workload: iterative fibonacci(ZIREN_BENCH_FIB_N,
58218) in shards of ZIREN_BENCH_SHARD_SIZE (2^16 - 64) cycles, the
reference's headline benchmark (BASELINE.md); its CPU prover runs it at
about 25 kHz, which is the baseline. vs_baseline is computed only at the
core config, and is null otherwise.

The prover is the port's torch shard prover on the GPU (stark/machine.py:
StarkMachine.prove with fix_shapes=True; under ZIREN_FUSED=1 its CUDA
graphs, stark/tfused.py). A canary process first runs one tiny CUDA op
within 120 s; then the stages run in a child process
(ZIREN_BENCH_CHILD=1) within ZIREN_BENCH_BUDGET_S (900 s) seconds. The
child emits a line per stage: `warmup-incl-loads` (the first prove,
kernel builds and caches included), `prove-only` (the same records, warm)
and `full` (execute, then prove, then verify_mips_proof). The parent
echoes the child's output on stderr and prints its LAST line, also after
killing a child that ran out of its budget. There is no host fallback:
with a failed canary, or no line from the child, the cause goes to stderr
(fallback_cause, rc, stderr_tail) and the script exits nonzero, printing
no metric line.

Each line's detail holds bench.py's keys (workload, cycles, shards,
prove_s, backend, staged, fri, config) and: the card's name and power limit
as nvidia-smi prints them, `fused` (tfused.enabled()), `peak_bytes` (the
device's peak allocation since the stage began) and, on `full`, the prove's
legs from StarkMachine.prove(..., stats=): trace-generation wait, dispatch
(a fused prove's calls), fetch and assembly seconds.

`main(device="cpu", config="dev")` runs the stages in the calling process
on the CPU, without a child or a canary: that is what the tests do.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from ..device import resolve_device

BASELINE_KHZ = 25.0  # the reference's CPU core-prove rate (see above)
CONFIGS = ("core", "dev")
# the child runs the module from the root of the checkout that holds it
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _emit(khz: float, *, config: str, detail: dict) -> None:
    vs = round(khz / BASELINE_KHZ, 3) if config == "core" else None
    detail["config"] = config
    print(json.dumps({
        "metric": "core_prove_khz",
        "value": round(khz, 3),
        "unit": "kHz",
        "vs_baseline": vs,
        "detail": detail,
    }), flush=True)


def _last_json_line(text: str) -> str | None:
    out = None
    for line in text.splitlines():
        if line.startswith("{"):
            out = line
    return out


def _run_child(budget: int):
    """Run the stages as a budgeted child.

    Returns (result_line | None, cause | None). A timed-out child that
    already emitted a staged line still counts."""
    import signal
    import tempfile

    env = dict(os.environ, ZIREN_BENCH_CHILD="1")
    # file-backed stdout/stderr and a kill of the process group: a helper
    # that inherits a pipe's descriptor can hang a pipe-based wait forever
    with tempfile.NamedTemporaryFile(mode="w+", suffix=".out") as f, \
         tempfile.NamedTemporaryFile(mode="w+", suffix=".err") as ferr:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ziren_tpu_torch.tools.bench"],
            env=env, stdout=f, stderr=ferr, cwd=ROOT,
            start_new_session=True,
        )
        timed_out = False
        try:
            proc.wait(timeout=budget)
        except subprocess.TimeoutExpired:
            timed_out = True
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                proc.kill()
            proc.wait()
        f.seek(0)
        out = f.read()
        sys.stderr.write(out)  # every staged line, the last also on stdout
        line = _last_json_line(out)
        if line is not None:
            return line, None
        ferr.seek(0)
        tail = ferr.read()[-600:]
        if timed_out:
            return None, {"fallback_cause": "child-timeout",
                          "budget_s": budget, "stderr_tail": tail}
        return None, {"fallback_cause": "child-error",
                      "rc": proc.returncode, "stderr_tail": tail}


def _canary() -> dict | None:
    """None when one tiny CUDA op completes in a process of its own within
    120 s, else the cause."""
    try:
        canary = subprocess.run(
            [sys.executable, "-c",
             "import torch; x = torch.arange(8, device='cuda') * 3 + 1;"
             "torch.cuda.synchronize(); print('ok' if int(x[-1]) == 22 else 'wrong')"],
            env=dict(os.environ), timeout=120, capture_output=True,
            text=True, start_new_session=True,
        )
    except subprocess.TimeoutExpired:
        return {"fallback_cause": "canary-timeout"}
    if canary.stdout.strip() == "ok":
        return None
    return {"fallback_cause": "canary-error", "rc": canary.returncode,
            "stderr_tail": canary.stderr[-600:]}


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def stages(device, config: str = "core") -> None:
    """The three stages on `device` (a resolved torch device), one line
    each."""
    from ..executor.asm import fibonacci_program
    from ..machine.mips import execute_sharded, mips_machine, verify_mips_proof
    from ..stark import tfused
    from ..stark.config import core_config, dev_config

    n = int(os.environ.get("ZIREN_BENCH_FIB_N", "58218"))
    # shards a hair under 2^16 cycles: the branch and delay-slot rule can run
    # a shard one cycle past shard_size, which would double the padded Cpu
    # trace to 2^17
    shard_size = int(os.environ.get("ZIREN_BENCH_SHARD_SIZE", str((1 << 16) - 64)))
    cuda = device.type == "cuda"
    smi = card() if cuda else None

    program = fibonacci_program(n)
    machine = mips_machine(core_config() if config == "core" else dev_config())
    pk, vk = machine.setup(program)
    fri = machine.config.fri

    def prove(records, stats=None):
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        proof = machine.prove(pk, records, fix_shapes=True, device=device, stats=stats)
        if cuda:
            torch.cuda.synchronize(device)
        return proof, time.perf_counter() - t0

    def detail(prove_s, cycles, shards, staged):
        return {
            "workload": f"fibonacci({n})",
            "cycles": cycles,
            "shards": shards,
            "prove_s": round(prove_s, 3),
            "backend": device.type,
            "staged": staged,
            "fri": f"log_blowup={fri.log_blowup}, {fri.num_queries} queries, "
                   f"{fri.proof_of_work_bits} PoW bits",
            "card": smi,
            "fused": tfused.enabled(),
            "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
        }

    # warmup: the timed path itself, so that its kernels are built and its
    # caches (device keys, constants, graphs under ZIREN_FUSED=1) filled;
    # emitted, pessimistic, so that a child killed after it leaves a rate
    warm, warm_records = execute_sharded(program, shard_size)
    _proof, warm_dt = prove(warm_records)
    c0 = int(warm.global_clk)
    _emit(c0 / warm_dt / 1e3, config=config,
          detail=detail(warm_dt, c0, len(warm_records), "warmup-incl-loads"))

    # prove-only on the warm records
    _proof, dt1 = prove(warm_records)
    _emit(c0 / dt1 / 1e3, config=config,
          detail=detail(dt1, c0, len(warm_records), "prove-only"))

    # the full workload, end to end: execute, trace generation, prove
    stats: dict = {}
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    ex, records = execute_sharded(program, shard_size)
    proof, _prove_s = prove(records, stats)
    dt = time.perf_counter() - t0
    cycles = int(ex.global_clk)
    if not verify_mips_proof(machine, vk, proof, pc_start=program.pc_start):
        raise AssertionError("the full stage's proof does not verify")
    d = detail(dt, cycles, len(records), "full")
    d["verified"] = True
    d["legs_s"] = {
        "trace_wait": round(sum(stats["trace_wait_s"]), 4),
        "dispatch": round(sum(stats.get("dispatch_s", stats.get("call_s", []))), 4),
        "fetch": round(stats["fetch_s"], 4),
        "assemble": round(stats["assemble_s"], 4),
    }
    _emit(cycles / dt / 1e3, config=config, detail=d)


def main(device=None, config: str = "core") -> None:
    """device None is the GPU: a canary, then the stages in a budgeted
    child (or in this process, in the child itself). "cpu" runs the stages
    here on the CPU, for the tests; "host" is refused, since the bench
    measures the torch prover."""
    if config not in CONFIGS:
        raise ValueError(f"config is core or dev: {config!r}")
    if device == "host":
        raise ValueError("the bench measures the torch prover: pass cpu, or leave the "
                         "device out for the GPU")
    if device is None and os.environ.get("ZIREN_BENCH_CHILD") != "1":
        budget = int(os.environ.get("ZIREN_BENCH_BUDGET_S", "900"))
        cause = _canary()
        if cause is None:
            line, cause = _run_child(budget)
            if line is not None:
                print(line, flush=True)
                return
        print(json.dumps(cause), file=sys.stderr, flush=True)
        raise SystemExit(1)
    stages(resolve_device(device), config)


def cli(argv=None):
    argparse.ArgumentParser(
        prog="python -m ziren_tpu_torch.tools.bench",
        description="core_prove_khz on the GPU; the workload from ZIREN_BENCH_FIB_N, "
                    "ZIREN_BENCH_SHARD_SIZE and ZIREN_BENCH_BUDGET_S").parse_args(argv)
    return main()


if __name__ == "__main__":
    cli()
