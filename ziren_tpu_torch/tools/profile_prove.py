"""Profile the port's prover pipeline on a fibonacci workload: cProfile
around one machine.prove of a single-shard execution.

    python -m ziren_tpu_torch.tools.profile_prove [n] [config] [--device cpu|host|cuda:K]

Prints cycles, setup, prove and verify seconds and the rate, then the 25
most expensive calls by cumulative time. The prover runs on the GPU unless
--device names the CPU or the host numpy prover; machine.prove fetches the
proof to the host, so its seconds include the card's work. cProfile sees
the host's calls: a kernel's time shows as the wait that follows it.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import time

from ..device import prover_device
from ..executor.asm import fibonacci_program
from ..machine.mips import execute, mips_machine
from ..stark.config import core_config, dev_config


def main(n=500, config="dev", device=None):
    device = prover_device(device)
    program = fibonacci_program(n)
    machine = mips_machine(dev_config() if config == "dev" else core_config())
    t0 = time.perf_counter()
    pk, vk = machine.setup(program)
    t_setup = time.perf_counter() - t0
    ex, record = execute(program)
    cycles = ex.global_clk
    t0 = time.perf_counter()
    pr = cProfile.Profile()
    pr.enable()
    proof = machine.prove(pk, [record], device=device)
    pr.disable()
    t_prove = time.perf_counter() - t0
    t0 = time.perf_counter()
    machine.verify(vk, proof)
    t_verify = time.perf_counter() - t0
    print(f"cycles={cycles} setup={t_setup:.2f}s prove={t_prove:.2f}s "
          f"verify={t_verify:.2f}s khz={cycles / t_prove / 1000:.2f}")
    s = io.StringIO()
    ps = pstats.Stats(pr, stream=s).sort_stats("cumulative")
    ps.print_stats(25)
    print(s.getvalue(), flush=True)
    return proof


def cli(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ziren_tpu_torch.tools.profile_prove")
    ap.add_argument("n", nargs="?", type=int, default=500)
    ap.add_argument("config", nargs="?", default="dev", choices=["dev", "core"])
    ap.add_argument("--device", default=None,
                    help="where the prover runs: the GPU when left out, cpu, or host")
    return main(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    cli()
