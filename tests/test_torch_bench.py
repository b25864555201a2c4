"""The port's benchmark entry point (ziren_tpu_torch/tools/bench.py) on the
CPU: its stages with device="cpu" at the dev config on one shard (one
prove each: warmup, prove-only, then execute and prove), its line against
the JAX repo's bench.py, and the refusals: no CUDA and no device, the host
prover. The stages at the core config are a slow case."""

import contextlib
import io
import json
import os

import pytest
import torch

import bench as jax_bench
from ziren_tpu_torch.tools import bench

# two torch threads: the stages prove one MIPS shard three times, about 21 s
# a prove on one thread
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)

# bench.py's detail keys (its main's detail(), and _emit's config)
BENCH_PY_KEYS = {"workload", "cycles", "shards", "prove_s", "backend", "staged", "fri",
                 "config"}
STAGES = ["warmup-incl-loads", "prove-only", "full"]


def _lines(monkeypatch, capsys, n, config):
    monkeypatch.setenv("ZIREN_BENCH_FIB_N", str(n))
    monkeypatch.delenv("ZIREN_BENCH_SHARD_SIZE", raising=False)
    bench.main(device="cpu", config=config)
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def _check(lines, config, queries):
    assert [ln["detail"]["staged"] for ln in lines] == STAGES
    for ln in lines:
        assert set(ln) == {"metric", "value", "unit", "vs_baseline", "detail"}
        assert (ln["metric"], ln["unit"]) == ("core_prove_khz", "kHz") and ln["value"] > 0
        d = ln["detail"]
        assert BENCH_PY_KEYS <= set(d) and d["config"] == config
        assert d["backend"] == "cpu" and d["card"] is None and d["peak_bytes"] is None
        assert d["fused"] is False and d["shards"] == 1 and f"{queries} queries" in d["fri"]
        assert ln["vs_baseline"] == (round(ln["value"] / 25.0, 3) if config == "core" else None)
    full = lines[-1]["detail"]
    assert full["verified"] is True
    assert set(full["legs_s"]) == {"trace_wait", "dispatch", "fetch", "assemble"}


def test_the_stages_print_three_lines(monkeypatch, capsys):
    _check(_lines(monkeypatch, capsys, 20, "dev"), "dev", 8)


@pytest.mark.slow
def test_the_stages_at_the_core_config(monkeypatch, capsys):
    _check(_lines(monkeypatch, capsys, 20, "core"), "core", 84)


def test_emit_is_bench_pys_line(capsys):
    for config in ("core", "dev"):
        bench._emit(50.0, config=config, detail={"staged": "full"})
        ours = capsys.readouterr().out
        jax_bench._emit(50.0, config=config, detail={"staged": "full"})
        assert ours == capsys.readouterr().out
        assert json.loads(ours)["vs_baseline"] == (2.0 if config == "core" else None)
    assert bench._last_json_line("x\n{1}\ny\n{2}\nz") == "{2}"


def test_without_cuda_main_fails_and_prints_no_line(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    monkeypatch.delenv("ZIREN_BENCH_CHILD", raising=False)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        with pytest.raises(SystemExit) as e:
            bench.main()
    assert e.value.code != 0
    assert out.getvalue() == ""
    cause = json.loads(err.getvalue().strip().splitlines()[-1])
    assert cause["fallback_cause"] == "canary-error" and cause["rc"] != 0
    assert "stderr_tail" in cause


def test_the_child_without_cuda_raises(monkeypatch):
    """The child (ZIREN_BENCH_CHILD=1) runs the stages on the GPU only."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    monkeypatch.setenv("ZIREN_BENCH_CHILD", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main()


def test_the_host_prover_is_refused():
    with pytest.raises(ValueError, match="torch prover"):
        bench.main(device="host")
