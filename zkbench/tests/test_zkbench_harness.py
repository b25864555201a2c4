"""CPU tests of the benchmark's harness: the cells and files it finds by
name, the guests against the port's executor, the trace arithmetic, the
import guard and the command's refusal without a card.

    python -m pytest -q zkbench/tests
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from zkbench import cells, devtrace, guard
from zkbench.generator import Traffic

CHECKOUT = cells.CHECKOUT
SPEC = json.load(open(os.path.join(CHECKOUT, "BENCHMARK.json")))
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads(name):
    cell = cells.Bench().cell(name)
    entry = next(w for w in SPEC["workloads"] if w["name"] == name)
    config = next(c for c in SPEC["configs"] if c["name"] == entry["config"])
    assert config["file"] == f"zkbench/configs/{entry['config']}.json"
    assert cell.config["name"] == entry["config"]
    traffic = Traffic(cell, 2**40 + 7)
    assert callable(traffic.guest.build) and callable(cell.expected().expected)
    assert len(traffic.inputs(0)) >= 1
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        reader = cell.reader(m["name"])
        assert reader.UNIT == m["unit"] and callable(reader.read)
        if m in cell.per_layer:
            assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]
            assert m["moves"] in e2e


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["zkbench"] and 1 <= SPEC["run_seconds"] <= 51
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        with open(os.path.join(CHECKOUT, c["file"])) as f:
            assert set(c["reduced"]) == set(json.load(f)["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs)) and all(w["chips"] == 1 for w in SPEC["workloads"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_cell_config_traffic_and_metric_are_found_from_new_files_alone(tmp_path):
    root = tmp_path / "zkbench"
    shutil.copytree(cells.HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.load(open(root / "configs" / "fib-core.json"))
    cfg["name"] = "fib-dev"
    cfg["stark_config"] = "dev"
    (root / "configs" / "fib-dev.json").write_text(json.dumps(cfg))
    (root / "traffic" / "prove-n30.json").write_text(json.dumps(
        {"request": "prove", "guest_args": {"n": 30}, "loop": "closed", "clients": 1}))
    (root / "metrics" / "requests.done.py").write_text(
        'UNIT = "1"\nLAYER = "entry"\nMOVES = "prove_khz"\nWRAPS = []\n\n\n'
        "def read(run):\n    return len(run.done) or None\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "fib-dev.prove-n30", "config": "fib-dev",
                              "traffic": "prove-n30", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "requests.done", "unit": "1", "better": "higher",
                              "source": "program_counter", "layer": "entry",
                              "moves": "prove_khz", "workloads": ["fib-dev.prove-n30"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = cells.Bench(str(tmp_path / "BENCHMARK.json"), str(root)).cell("fib-dev.prove-n30")
    assert cell.config["stark_config"] == "dev" and cell.guest_args() == {"n": 30}
    assert [m["name"] for m in cell.per_layer] == ["requests.done"]

    class FakeRun:
        done = [1, 2, 3]
    assert cell.reader("requests.done").read(FakeRun()) == 3
    assert cell.expected().expected(Traffic(cell, 1).inputs(0), n=30)["cycles"] == 6 * 30 + 15


@pytest.mark.parametrize("guest,args", [("fib", {"n": 700}), ("sha2chain", {"rounds": 9})])
@pytest.mark.parametrize("seed", [0, 2**40 + 11])
def test_reference_outputs_equal_the_ports_executor(guest, args, seed):
    from ziren_tpu_torch.executor import Executor, asm

    mod = cells.load_module(os.path.join(cells.HERE, "programs", guest + ".py"), "programs", guest)
    ref = cells.load_module(os.path.join(cells.HERE, "reference", guest + ".py"),
                            "reference", guest)
    bufs = mod.inputs(np.random.default_rng([seed, 1]), **args)
    ex = Executor(mod.build(asm, **args), stdin=bufs, shard_size=1 << 12)
    ex.run_sharded()
    want = ref.expected(bufs, **args)
    assert [int(w) for w in ex.committed_values] == want["words"]
    assert int(ex.global_clk) == want["cycles"]


def test_seeded_fibonacci_costs_the_ports_loop_plus_its_stdin_read():
    """The seeded guest runs the port's fibonacci_program(n) loop; reading its
    starting pair from stdin costs five instructions more (HINT_READ's four,
    the base, two loads, against the port's two immediates)."""
    from zkbench.programs import fib
    from ziren_tpu_torch.executor import Executor, asm

    for n in (100, 58218):
        port = Executor(asm.fibonacci_program(n))
        port.run()
        seeded = Executor(fib.build(asm, n), stdin=fib.inputs(np.random.default_rng(n), n))
        seeded.run()
        assert seeded.global_clk == port.global_clk + 5


def test_reference_programs_equal_the_ports():
    """Both sides build the same instruction words: the port's asm and the
    reference's frozen copy of it."""
    from zkbench.programs import fib, sha2chain
    from zkbench.reference.zkvm.executor import asm as ref_asm
    from ziren_tpu_torch.executor import asm

    for mod, args in ((fib, {"n": 58218}), (sha2chain, {"rounds": 230})):
        a, b = mod.build(asm, **args), mod.build(ref_asm, **args)
        assert [vars(i) for i in a.instructions] == [vars(i) for i in b.instructions]
        assert a.pc_start == b.pc_start


@pytest.mark.parametrize("name,base", [
    ("(anonymous namespace)::hash_rows_kernel(long const*, long*, long long, long long)",
     "hash_rows_kernel"),
    ("void (anonymous namespace)::grind_kernel<4>(long const*, int)", "grind_kernel"),
    ("_ZN12_GLOBAL__N_116hash_rows_kernelEPKlPlxx", "hash_rows_kernel"),
    ("_Z14permute_kernelPKlPlx", "permute_kernel"),
    ("void at::native::vectorized_elementwise_kernel<2, at::native::F>(int, std::array<char*, 2ul>)",
     "vectorized_elementwise_kernel"),
])
def test_kernel_names_reduce_to_their_function(name, base):
    assert devtrace.kernel_base(name) == base


def test_busy_seconds_and_gaps():
    ivs = [(10, 20), (15, 30), (40, 50), (90, 120)]
    assert devtrace.union_seconds(ivs, 0, 100) * 1e9 == pytest.approx(40)
    assert devtrace.gaps(ivs, 0, 100) == [(0, 10), (30, 40), (50, 90)]
    t = devtrace.DeviceTrace(events=[("a", s, e) for s, e in ivs], t0=0, t1=100)
    # a gap is split where the host's span changes, not labelled whole by its middle
    idle = t.idle_by_label([(0, 36, "x"), (36, 80, "y")])
    assert idle["x"] * 1e9 == pytest.approx(16) and idle["y"] * 1e9 == pytest.approx(34)
    assert idle["between requests"] * 1e9 == pytest.approx(10)


def test_import_guard_compares_top_level_names_whole():
    assert guard.forbidden(["ziren_tpu_torch", "ziren_tpu_torch.sdk", "numpy"]) == []
    assert guard.forbidden(["ziren_tpu.sdk", "jaxlib.xla", "ziren_tpu_torch"]) == ["jaxlib",
                                                                                 "ziren_tpu"]
    code = ("import ziren_tpu_torch.sdk; from zkbench.guard import forbidden; "
            "assert forbidden() == [], forbidden(); import ziren_tpu; "
            "assert 'ziren_tpu' in forbidden(), forbidden(); print('ok')")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_the_command_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "zkbench/run.py", "--workload", CELLS[0], "--seed",
                          str(2**40 + 3), "--seconds", "1", "--trace", "0"], cwd=CHECKOUT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "{" not in out.stdout


def test_the_command_fails_beside_the_benchmark_alone(tmp_path):
    """In a directory that holds only BENCHMARK.json and zkbench/, the
    command prints no result and exits non-zero, card or no card."""
    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cells.HERE, tmp_path / "zkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "zkbench/run.py", "--workload", CELLS[0], "--seed",
                          "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "{" not in out.stdout
