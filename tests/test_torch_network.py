"""The port's prover RPC service (ziren_tpu_torch.network) on the CPU: the
round trip of the JAX package's tests/test_network.py against the port's
server with device="cpu", the proof byte-equal to the port's in-process
prove and to the JAX package's; the error envelope; signed requests; what
the wire's allowlist lets through and what it refuses; and that a reply
holds no torch object. Tolerance 0: proofs are compared as bytes."""

import io
import os
import pickle
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from collections import OrderedDict

import pytest
import torch

import ziren_tpu.executor.asm as jasm
import ziren_tpu.network.wire as jwire
import ziren_tpu.sdk as jsdk
import ziren_tpu.stark.serialize as jser
import ziren_tpu_torch.executor.asm as tasm
import ziren_tpu_torch.sdk as tsdk
import ziren_tpu_torch.stark.serialize as tser
from ziren_tpu_torch.network import NetworkProver, ProverServer, auth, wire
from ziren_tpu_torch.network.client import NetworkProverError
from ziren_tpu_torch.network.service import ProverService, program_id

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

N = 100


@pytest.fixture(scope="module")
def server():
    with ProverServer(config="dev", device="cpu") as srv:
        yield srv


@pytest.fixture(scope="module")
def served(server):
    """Setup, execute and one prove of fibonacci(100) over the RPC surface."""
    prover = NetworkProver(server.endpoint, config="dev")
    assert prover.ready()
    prog = tasm.fibonacci_program(N)
    pk, vk = prover.setup(prog)
    values, report = prover.execute(pk)
    proof = prover.prove(pk)  # verify=True: checked by the client's own ProverClient
    return prover, prog, pk, vk, values, report, proof


def _globals_of(blob: bytes) -> set:
    """Every (module, name) that unpickling `blob` resolves."""
    seen = set()

    class Recorder(pickle.Unpickler):
        def find_class(self, module, name):
            seen.add((module, name))
            return super().find_class(module, name)

    Recorder(io.BytesIO(blob)).load()
    return seen


def test_round_trip_matches_the_in_process_prove(served):
    prover, prog, pk, vk, values, report, proof = served
    assert report.exit_code == 0 and report.total_instruction_count > N
    assert proof.proof is not None and proof._records is None
    local = tsdk.ProverClient(config="dev", device="cpu")
    lpk, lvk = local.setup(prog)
    want = local.prove(lpk)
    assert tser.serialize_machine_proof(proof.proof) == tser.serialize_machine_proof(want.proof)
    assert proof.public_values == want.public_values == values
    assert local.verify(proof, lvk)


def test_round_trip_matches_the_jax_package(served):
    proof = served[6]
    jc = jsdk.ProverClient(config="dev")
    jpk, jvk = jc.setup(jasm.fibonacci_program(N))
    blob = tser.serialize_machine_proof(proof.proof)
    assert blob == jser.serialize_machine_proof(jc.prove(jpk).proof)
    assert jc.verify(jsdk.ZirenProofWithPublicValues(
        jser.deserialize_machine_proof(blob),
        jsdk.PublicValuesStream(list(proof.public_values.words))), jvk)


def test_a_second_setup_builds_no_second_key(server, served):
    prover, prog, pk = served[:3]
    before = dict(server.service._keys)
    pk2, _vk2 = prover.setup(prog)
    assert pk2.program_id == pk.program_id == program_id(prog)
    assert server.service._keys[pk.program_id] is before[pk.program_id]
    assert len(server.service._keys) == len(before)
    assert program_id(tasm.fibonacci_program(N + 1)) != pk.program_id


def test_error_envelope_and_the_server_goes_on(server, served):
    prover = served[0]
    unknown = types.SimpleNamespace(program_id="feed" * 16, vk_handle=None)
    with pytest.raises(NetworkProverError, match="unknown program id"):
        prover.prove(unknown)
    with pytest.raises(NetworkProverError, match="unknown program id"):
        prover.execute(unknown)
    assert prover.ready()
    assert prover.execute(served[2])[1].exit_code == 0


def test_the_server_verifies_too(served):
    prover, _prog, pk, _vk, _values, _report, proof = served
    assert prover._call("Verify", {"program_id": pk.program_id, "proof": proof}) == {"ok": True}
    proof.public_values.words[0] ^= 1
    try:
        with pytest.raises(NetworkProverError, match="committed_value_digest"):
            prover._call("Verify", {"program_id": pk.program_id, "proof": proof})
    finally:
        proof.public_values.words[0] ^= 1


def test_unknown_routes_are_404(server):
    for path in ("/twirp/ProverService/_pk", "/twirp/ProverService/Nope", "/elsewhere"):
        req = urllib.request.Request(server.endpoint + path, data=wire.dumps({}))
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 404


def test_signed_and_wrongly_signed_requests():
    key = "a3" * 32
    with ProverServer(config="dev", key=key, device="cpu") as srv:
        assert NetworkProver(srv.endpoint, config="dev", key=key).ready()
        for bad_key in (None, "b4" * 32):  # unsigned, wrongly signed: 401 before unpickling
            with pytest.raises(urllib.error.HTTPError) as e:
                NetworkProver(srv.endpoint, config="dev", key=bad_key).ready()
            assert e.value.code == 401
        body = wire.dumps({})
        headers = auth.sign_headers(auth.load_key(key), "Ready", body)
        url = srv.endpoint + "/twirp/ProverService/Ready"

        def post(h):
            req = urllib.request.Request(
                url, data=body, headers={"Content-Type": "application/octet-stream", **h})
            with urllib.request.urlopen(req, timeout=30) as resp:
                return wire.loads(resp.read())

        assert post(headers)["ok"]
        with pytest.raises(urllib.error.HTTPError):
            post(headers)  # the same nonce again
        with pytest.raises(urllib.error.HTTPError):
            post(auth.sign_headers(auth.load_key(key), "Setup", body))  # another method's


def test_a_replayed_request_passes_once():
    """Sixteen threads replay one signed request at once, as the threaded
    server would take sixteen copies of it; the nonce store yields inside
    its freshness test. Exactly one copy passes: the test, the insert and
    the eviction are one step under the verifier's lock."""

    class YieldingNonces(OrderedDict):
        def __contains__(self, nonce):
            fresh = not super().__contains__(nonce)
            time.sleep(0.01)  # another thread runs between the test and the insert
            return not fresh

    key = auth.load_key("a3" * 32)
    verifier = auth.RequestVerifier(key)
    verifier._nonces = YieldingNonces()
    body = wire.dumps({})
    headers = auth.sign_headers(key, "Ready", body)
    copies = 16
    start = threading.Barrier(copies)
    passed, refused = [], []

    def replay():
        start.wait(timeout=30)
        try:
            verifier.verify("Ready", headers, body)
            passed.append(1)
        except auth.AuthError as e:
            refused.append(str(e))

    threads = [threading.Thread(target=replay) for _ in range(copies)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(passed) == 1 and refused == ["nonce replay"] * (copies - 1)
    assert list(verifier._nonces) == [headers[auth.HDR_NONCE]]


def test_without_a_key_the_service_is_open():
    with ProverServer(config="dev", device="cpu") as srv:
        assert NetworkProver(srv.endpoint, config="dev").ready()


def _global(module: str, name: str) -> bytes:
    return b"\x80\x04" + pickle.GLOBAL + f"{module}\n{name}\n".encode() + b"."


@pytest.mark.parametrize("module,name", [
    ("os", "system"), ("subprocess", "Popen"), ("builtins", "eval"),
    ("torch", "Tensor"), ("torch._utils", "_rebuild_tensor_v2"), ("torch.storage", "_load_from_bytes"),
    ("ziren_tpu.sdk", "ZirenStdin"), ("ziren_tpu.executor.program", "Program"),
    ("ziren_tpu", "sdk"),
    ("ziren_tpu_torchx", "Thing"), ("ziren_tpu_torchx.sub", "Thing"),
    ("ziren_tpu_torch.sdk", "create_prover"), ("ziren_tpu_torch.network.wire", "loads"),
    # a dotted name walks attributes from a module of this package to what it imported
    ("ziren_tpu_torch.core.p2_native", "subprocess.Popen"),
    ("ziren_tpu_torch.kernels", "torch.Tensor"),
    ("ziren_tpu_torch.kernels", "subprocess.Popen"),
    ("ziren_tpu_torch.sdk", "ZirenStdin.__class__"),
    # and a class that a module of this package imported is not this package's
    ("ziren_tpu_torch.network.service", "ThreadingHTTPServer"),
    ("ziren_tpu_torch.network.wire", "WireError.__base__"),
])
def test_the_wire_refuses(module, name, monkeypatch):
    """Anything but numpy's reconstruction helpers, a few builtins and the
    classes of this package; a package whose name merely starts with this
    one's letters is refused, and so are a function of this package, a dotted
    path through one of its modules and a class that it only imported."""
    fake = types.ModuleType("ziren_tpu_torchx")
    fake.Thing = type("Thing", (), {})
    monkeypatch.setitem(sys.modules, "ziren_tpu_torchx", fake)
    monkeypatch.setitem(sys.modules, "ziren_tpu_torchx.sub", fake)
    with pytest.raises(wire.WireError):
        wire.loads(_global(module, name))


def test_the_wire_refuses_a_tensor_and_a_jax_package_object():
    with pytest.raises(wire.WireError, match="torch"):
        wire.loads(pickle.dumps({"x": torch.arange(4)}))
    with pytest.raises(wire.WireError, match="ziren_tpu.sdk"):
        wire.loads(jwire.dumps(jsdk.ZirenStdin()))
    with pytest.raises(jwire.WireError, match="ziren_tpu_torch.sdk"):
        jwire.loads(wire.dumps(tsdk.ZirenStdin()))  # nor the other way round


def test_the_wire_carries_this_packages_classes(served):
    prog, proof = served[1], served[6]
    back = wire.loads(wire.dumps({"program": prog, "proof": proof, "n": [1, b"x", None]}))
    assert program_id(back["program"]) == program_id(prog)
    assert (tser.serialize_machine_proof(back["proof"].proof)
            == tser.serialize_machine_proof(proof.proof))
    assert back["n"] == [1, b"x", None]


def _no_torch(blob: bytes) -> set:
    found = _globals_of(blob)
    assert found and not [g for g in found if g[0].split(".")[0] == "torch"], found
    assert {g[0].split(".")[0] for g in found} <= {"ziren_tpu_torch", "numpy", "builtins",
                                                   "collections"}, found
    assert b"_torch_data_cache" not in blob
    wire.loads(blob)  # and the allowlist takes all of it
    return found


def test_a_prove_core_reply_holds_no_torch_object(server, served):
    """The reply as the handler builds it, after a prove with device="cpu"
    has hung its tensor cache on the server's proving key."""
    pk = served[2]
    spk, _svk = server.service._keys[pk.program_id]
    assert getattr(spk.pk, "_torch_data_cache", None), "the prove left no cache on the key"
    reply = server.service.ProveCore({"program_id": pk.program_id})
    found = _no_torch(wire.dumps({"ok": True, "result": reply}))
    assert ("ziren_tpu_torch.sdk", "ZirenProofWithPublicValues") in found


def test_a_compressed_prove_reply_holds_no_torch_object(monkeypatch):
    """CompressedProve's reply (rec_machine, rec_vk, final shard proof) after
    a one-shard compress with device="cpu". The registry is the lift-only
    one here; the default (the full enumeration, minutes) is held by the
    slow case of tests/test_torch_sdk.py."""
    from ziren_tpu_torch.recursion import mips_pipeline as mp

    full = mp.compress

    def compress(machine, vk, machine_proof, config=None, registry=None, **kw):
        registry = registry or mp.build_lift_registry(machine, vk, machine_proof.shard_proofs,
                                                      config=config)
        return full(machine, vk, machine_proof, config=config, registry=registry, **kw)

    monkeypatch.setattr(mp, "compress", compress)
    service = ProverService(config="dev", device="cpu")
    prog = tasm.fibonacci_program(20)
    pid = service.Setup({"program": prog})["program_id"]
    reply = service.CompressedProve({"program_id": pid})
    found = _no_torch(wire.dumps({"ok": True, "result": reply}))
    assert {"ziren_tpu_torch.stark.machine", "ziren_tpu_torch.stark.proof"} <= {g[0] for g in found}
    rm, rvk, final_sp = wire.loads(wire.dumps(reply))["compressed"]
    from ziren_tpu_torch.stark.proof import MachineProof

    assert rm.verify(rvk, MachineProof([final_sp]))


@pytest.mark.skipif(torch.cuda.is_available(), reason="this machine has a CUDA device")
def test_a_server_without_a_device_fails_at_the_first_prove():
    """ProverServer() is the GPU's: it starts, sets up and executes on the
    host, and its first prove comes back as the CUDA check's error."""
    with ProverServer(config="dev") as srv:
        prover = NetworkProver(srv.endpoint, config="dev")
        pk, _vk = prover.setup(tasm.fibonacci_program(10))
        assert prover.execute(pk)[1].exit_code == 0
        with pytest.raises(NetworkProverError, match="CUDA is not available"):
            prover.prove(pk)
        assert prover.ready()
