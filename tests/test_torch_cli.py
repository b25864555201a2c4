"""`python -m ziren_tpu_torch` against `python -m ziren_tpu`, on the CPU, on a
hand-written guest file (chip_smoke.minimal_elf: the repo holds no ELF):
execute, vkey, prove and verify through both packages' main(), stdout equal
apart from the program's name, proof files byte-equal. The port is asked for
`--device cpu`; without it the GPU is meant, and prove fails without one."""

import os
import subprocess
import sys

import pytest
import torch

from chip_smoke import minimal_elf
from ziren_tpu.__main__ import main as jmain
from ziren_tpu_torch.__main__ import main as tmain

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def elf(tmp_path_factory):
    path = tmp_path_factory.mktemp("guest") / "fib.elf"
    path.write_bytes(minimal_elf(10))
    return str(path)


def _both(capsys, argv, device=True):
    assert jmain(argv) == 0
    jout = capsys.readouterr().out
    assert tmain(argv + (CPU if device else [])) == 0
    return jout, capsys.readouterr().out


def test_execute(elf, capsys):
    jout, tout = _both(capsys, ["execute", elf, "--config", "dev"])
    assert tout == jout
    assert "cycles: 70\n" in tout and "exit_code: 0\n" in tout
    assert "committed: " + (89).to_bytes(4, "little").hex() in tout  # fib(10) steps on from 1


def test_vkey(elf, capsys):
    for config in ("dev", "core"):
        jout, tout = _both(capsys, ["vkey", elf, "--config", config])
        assert tout == jout and tout.startswith("vk: ") and len(tout.strip()) == 4 + 64


def test_vkey_needs_no_device(elf, capsys):
    """Setup is host work: without --device, and without a GPU, vkey runs."""
    jout, tout = _both(capsys, ["vkey", elf, "--config", "dev"], device=False)
    assert tout == jout


def test_prove_and_verify(elf, tmp_path, capsys):
    jp, tp = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    assert jmain(["prove", elf, "--config", "dev", "-o", jp]) == 0
    jout = capsys.readouterr().out
    assert tmain(["prove", elf, "--config", "dev", "-o", tp, *CPU]) == 0
    tout = capsys.readouterr().out
    assert tout.replace(tp, jp) == jout and "1 shard(s)" in tout
    with open(jp, "rb") as f, open(tp, "rb") as g:
        blob = g.read()
        assert blob == f.read() and len(blob) > 1000
    # each package verifies the other's file
    jout, tout = _both(capsys, ["verify", elf, tp, "--config", "dev"])
    assert tout == jout and tout.startswith("verification: ok (committed_value_digest: ")
    assert tmain(["verify", elf, jp, "--config", "dev"]) == 0  # host work: no --device needed
    capsys.readouterr()
    # a proof of another guest is refused by both
    other = str(tmp_path / "other.elf")
    with open(other, "wb") as f:
        f.write(minimal_elf(11))
    for main in (jmain, tmain):
        with pytest.raises(Exception):
            main(["verify", other, tp, "--config", "dev"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="this machine has a CUDA device")
def test_prove_without_device_means_the_gpu(elf, tmp_path):
    out = str(tmp_path / "p.bin")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain(["prove", elf, "--config", "dev", "-o", out])
    assert not os.path.exists(out)


@pytest.mark.skipif(torch.cuda.is_available(), reason="this machine has a CUDA device")
def test_the_module_runs_as_a_program(elf, tmp_path):
    """`python -m ziren_tpu_torch` in a process of its own: vkey runs, prove
    fails with the CUDA check's error and runs with --device cpu."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = str(tmp_path / "p.bin")

    def run(*argv):
        return subprocess.run([sys.executable, "-m", "ziren_tpu_torch", *argv], cwd=REPO,
                              env=env, capture_output=True, text=True, timeout=600)

    res = run("vkey", elf, "--config", "dev")
    assert res.returncode == 0 and res.stdout.startswith("vk: "), res.stderr[-2000:]
    res = run("prove", elf, "--config", "dev", "-o", out)
    assert res.returncode != 0 and "CUDA is not available" in res.stderr
    res = run("prove", elf, "--config", "dev", "-o", out, "--device", "cpu")
    assert res.returncode == 0 and os.path.getsize(out) > 1000, res.stderr[-2000:]
    res = run("verify", elf, out, "--config", "dev")
    assert res.returncode == 0 and "verification: ok" in res.stdout, res.stderr[-2000:]
    res = run("--help")
    assert "python -m ziren_tpu_torch" in res.stdout


def test_new_scaffolds_a_host_that_names_the_port(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert tmain(["new", "demo"]) == 0
    assert "python -m ziren_tpu_torch build program" in capsys.readouterr().out
    with open("demo/host.py") as f:
        host = f.read()
    assert "from ziren_tpu_torch.sdk import ProverClient, ZirenStdin" in host
    assert "from ziren_tpu_torch.guest import BincodeWriter, build_program" in host
    assert "ziren_tpu." not in host and "ziren_tpu " not in host
    compile(host, "host.py", "exec")
    assert jmain(["new", "jdemo"]) == 0
    capsys.readouterr()
    for rel in ("program/Cargo.toml", "program/src/main.rs"):
        with open(os.path.join("demo", rel)) as f, open(os.path.join("jdemo", rel)) as g:
            assert f.read() == g.read().replace("jdemo", "demo")
    with open("jdemo/host.py") as g:
        assert host == g.read().replace("ziren_tpu.", "ziren_tpu_torch.")
    assert tmain(["new", "demo"]) == 1  # refuses to clobber
    from ziren_tpu_torch.guest.build import find_toolchain

    if find_toolchain() is None:
        assert tmain(["build", "demo/program"]) == 1


def test_serve_takes_a_device(monkeypatch, capsys):
    """`serve --device cpu` hands the device to the server it starts."""
    import ziren_tpu_torch.network as tnet

    seen = {}

    class Server:
        endpoint = "http://127.0.0.1:0"

        def __init__(self, **kw):
            seen.update(kw)

        def start(self):
            raise KeyboardInterrupt

        def stop(self):
            seen["stopped"] = True

    monkeypatch.setattr(tnet, "ProverServer", Server)
    assert tmain(["serve", "--config", "dev", "--port", "0", *CPU]) == 0
    assert seen == {"host": "127.0.0.1", "port": 0, "config": "dev", "device": "cpu",
                    "stopped": True}
    assert tmain(["serve"]) == 0 and seen["device"] is None and seen["config"] == "core"
    capsys.readouterr()
