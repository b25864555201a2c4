"""The port's SDK (ziren_tpu_torch.sdk) against the JAX package's, on the
CPU, across the package border, tolerance 0: reports, keys and proofs are
compared exactly, proofs as bytes. Each package builds its own program,
keys and proof from the same inputs; the port proves with device="cpu" (the
plain versions of the kernels), the JAX package with its backend on a
machine without an accelerator. Pickles do not cross the packages, so what
crosses is serialize_machine_proof's bytes."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import ziren_tpu.executor.asm as jasm
import ziren_tpu.sdk as jsdk
import ziren_tpu.stark.serialize as jser
import ziren_tpu.stark.verifier as jverifier
import ziren_tpu_torch.executor.asm as tasm
import ziren_tpu_torch.sdk as tsdk
import ziren_tpu_torch.stark.serialize as tser
import ziren_tpu_torch.stark.verifier as tverifier
from chip_smoke import minimal_elf

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

N = 100


@pytest.fixture(scope="module")
def clients():
    return jsdk.ProverClient(config="dev"), tsdk.ProverClient(config="dev", device="cpu")


@pytest.fixture(scope="module")
def proved(clients):
    """fibonacci(100) at the dev config, set up and proved once a package."""
    jc, tc = clients
    jpk, jvk = jc.setup(jasm.fibonacci_program(N))
    tpk, tvk = tc.setup(tasm.fibonacci_program(N))
    return {"j": (jpk, jvk, jc.prove(jpk)), "t": (tpk, tvk, tc.prove(tpk))}


def _report(pv, report):
    return {"words": [int(w) for w in pv.words], "stream": bytes(pv.stream),
            **dataclasses.asdict(report)}


@pytest.mark.parametrize("n", [1, 25, N])
def test_execute_reports_are_equal(clients, n):
    jc, tc = clients
    got = _report(*tc.execute(tasm.fibonacci_program(n)))
    assert got == _report(*jc.execute(jasm.fibonacci_program(n)))
    assert got["exit_code"] == 0 and got["total_instruction_count"] > n


@pytest.mark.parametrize("n", [1, 10, 300])
def test_a_hand_written_elf_executes_alike(clients, n):
    """The minimal MIPS32 ELF of chip_smoke.py loads in both packages and
    runs as the asm-built fibonacci does."""
    jc, tc = clients
    got = _report(*tc.execute(minimal_elf(n)))
    assert got == _report(*jc.execute(minimal_elf(n)))
    asm = _report(*tc.execute(tasm.fibonacci_program(n)))  # the same loop, built in asm
    for key in ("words", "exit_code", "total_instruction_count", "syscall_counts"):
        assert got[key] == asm[key], key


def test_setup_gives_the_same_vk_commit(proved):
    (_jpk, jvk, _jp), (_tpk, tvk, _tp) = proved["j"], proved["t"]
    assert np.array_equal(np.asarray(jvk.vk.commit, np.uint32),
                          np.asarray(tvk.vk.commit, np.uint32))
    assert jvk.program_pc_start == tvk.program_pc_start
    assert list(jvk.vk.extra_observations) == list(tvk.vk.extra_observations)


def test_prove_is_byte_equal(proved):
    jproof, tproof = proved["j"][2], proved["t"][2]
    assert tser.serialize_machine_proof(tproof.proof) == jser.serialize_machine_proof(jproof.proof)
    assert tproof.public_values.words == jproof.public_values.words
    assert tproof.public_values.as_bytes() == jproof.public_values.as_bytes()
    assert tproof.public_values.digest_words() == jproof.public_values.digest_words()


def _carried(sdk, ser, blob, values):
    return sdk.ZirenProofWithPublicValues(
        ser.deserialize_machine_proof(blob),
        None if values is None else sdk.PublicValuesStream(list(values.words),
                                                           bytes(values.stream)))


def test_each_verify_accepts_the_others_proof(clients, proved):
    jc, tc = clients
    (_jpk, jvk, jproof), (_tpk, tvk, tproof) = proved["j"], proved["t"]
    assert tc.verify(tproof, tvk) and jc.verify(jproof, jvk)
    tblob = tser.serialize_machine_proof(tproof.proof)
    jblob = jser.serialize_machine_proof(jproof.proof)
    assert jc.verify(_carried(jsdk, jser, tblob, tproof.public_values), jvk)
    assert tc.verify(_carried(tsdk, tser, jblob, jproof.public_values), tvk)
    # a proof file alone: no claimed values, the digest is read from the proof
    assert tc.verify(_carried(tsdk, tser, jblob, None), tvk)


def test_a_tampered_public_value_is_refused_by_both(clients, proved):
    jc, tc = clients
    (_jpk, jvk, jproof), (_tpk, tvk, tproof) = proved["j"], proved["t"]
    blob = tser.serialize_machine_proof(tproof.proof)
    for sdk, ser, client, vk, err in ((jsdk, jser, jc, jvk, jverifier.VerificationError),
                                      (tsdk, tser, tc, tvk, tverifier.VerificationError)):
        bad = _carried(sdk, ser, blob, tproof.public_values)
        bad.public_values.words[0] ^= 1
        with pytest.raises(err, match="committed_value_digest"):
            client.verify(bad, vk)
        nine = _carried(sdk, ser, blob, tproof.public_values)
        nine.public_values.words = list(range(9))
        with pytest.raises(err, match="more than 8"):
            client.verify(nine, vk)


def test_a_tampered_proof_is_refused_by_both(clients, proved):
    jc, tc = clients
    (_jpk, jvk, _jp), (_tpk, tvk, tproof) = proved["j"], proved["t"]
    for sdk, ser, client, vk, err in ((jsdk, jser, jc, jvk, jverifier.VerificationError),
                                      (tsdk, tser, tc, tvk, tverifier.VerificationError)):
        bad = _carried(sdk, ser, tser.serialize_machine_proof(tproof.proof), None)
        sp = bad.proof.shard_proofs[0]
        opened = np.array(sp.opened_values[0].main.local)
        opened.flat[0] = (int(opened.flat[0]) + 1) % 2130706433
        sp.opened_values[0].main.local = opened.tolist()
        with pytest.raises((err, AssertionError)):
            client.verify(bad, vk)


def test_two_shards_are_byte_equal(clients):
    """shard_size cuts the execution in two; StarkMachine.prove proves the
    shards at their own shapes (fix_shapes=False), as the SDK asks."""
    jc, tc = clients
    jpk, jvk = jc.setup(jasm.fibonacci_program(300))
    tpk, tvk = tc.setup(tasm.fibonacci_program(300))
    jproof, tproof = jc.prove(jpk, shard_size=1024), tc.prove(tpk, shard_size=1024)
    assert len(tproof.proof.shard_proofs) == 2
    assert tser.serialize_machine_proof(tproof.proof) == jser.serialize_machine_proof(jproof.proof)
    assert tc.verify(tproof, tvk)


def test_stdin_buffers_are_equal():
    for sdk in (jsdk, tsdk):
        s = sdk.ZirenStdin().write_u32s([10, 0xFFFFFFFF]).write_slice(bytearray(b"ab"))
        assert s.buffers == [b"\x0a\x00\x00\x00\xff\xff\xff\xff", b"ab"]


@pytest.mark.parametrize("words,stream", [([89], b""), ([], b"hello"), (list(range(8)), b""),
                                          ([1, 2], b"\x00" * 40)])
def test_public_values_digest_words_are_equal(words, stream):
    j, t = jsdk.PublicValuesStream(words, stream), tsdk.PublicValuesStream(words, stream)
    assert t.digest_words() == j.digest_words() and t.as_bytes() == j.as_bytes()


def test_mock_prover():
    """The mock backend runs the guest, fabricates an empty proof with the
    real public values and checks digests only: it needs no device."""
    mock = tsdk.create_prover("mock", config="dev")
    assert isinstance(mock, tsdk.MockProver)
    pk, vk = mock.setup(tasm.fibonacci_program(50))
    proof = mock.prove(pk)
    assert proof.proof is None and mock.verify(proof, vk)
    jmock = jsdk.create_prover("mock", config="dev")
    jproof = jmock.prove(jmock.setup(jasm.fibonacci_program(50))[0])
    assert proof.public_values.words == jproof.public_values.words
    proof.public_values = None
    with pytest.raises(tverifier.VerificationError):
        mock.verify(proof, vk)


@pytest.mark.parametrize("mode,device", [("cuda", None), ("local", None), ("CUDA", None),
                                         ("cpu", "cpu")])
def test_create_prover_in_process_modes(mode, device):
    client = tsdk.create_prover(mode, config="dev")
    assert type(client) is tsdk.ProverClient and client._device == device


def test_create_prover_other_modes(monkeypatch):
    from ziren_tpu_torch.network import NetworkProver

    monkeypatch.delenv("ZIREN_PROVER", raising=False)
    monkeypatch.delenv("ZIREN_PROVER_ENDPOINT", raising=False)
    default = tsdk.create_prover(config="dev")  # the GPU, as ProverClient::cuda
    assert type(default) is tsdk.ProverClient and default._device is None
    monkeypatch.setenv("ZIREN_PROVER", "cpu")
    assert tsdk.create_prover(config="dev")._device == "cpu"
    assert isinstance(tsdk.create_prover("mock"), tsdk.MockProver)
    with pytest.raises(ValueError, match="endpoint"):
        tsdk.create_prover("network")
    assert isinstance(tsdk.create_prover("network", endpoint="http://127.0.0.1:1/"),
                      NetworkProver)
    for mode in ("tpu", "quantum"):
        with pytest.raises(ValueError, match="unknown prover mode"):
            tsdk.create_prover(mode)


@pytest.mark.skipif(torch.cuda.is_available(), reason="this machine has a CUDA device")
def test_device_none_is_the_gpu_and_raises_without_one():
    """ProverClient() sets up and executes on the host, and fails at the
    first prove: nothing carries on on the CPU unasked."""
    client = tsdk.ProverClient(config="dev")
    pk, vk = client.setup(tasm.fibonacci_program(10))
    assert client.execute(pk.program)[1].exit_code == 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        client.prove(pk)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        client.compressed_prove(pk)
    proof = tsdk.ProverClient(config="dev", device="cpu").prove(pk)
    assert client.verify(proof, vk)  # verification is host work


def test_groth16_prove_rejects_garbage():
    with pytest.raises((TypeError, AttributeError, ValueError)):
        tsdk.ProverClient(device="cpu").groth16_prove((None, None, None))


@pytest.mark.slow
def test_compressed_prove_is_byte_equal(clients):
    """The default registry (the full lift + join enumeration) in both
    packages: minutes each."""
    jc, tc = clients
    jpk, jvk = jc.setup(jasm.fibonacci_program(20))
    tpk, tvk = tc.setup(tasm.fibonacci_program(20))
    jcomp, tcomp = jc.compressed_prove(jpk), tc.compressed_prove(tpk)
    assert tser.serialize_shard_proof(tcomp[2]) == jser.serialize_shard_proof(jcomp[2])
    assert tc.verify_compressed(tcomp, tvk) == jc.verify_compressed(jcomp, jvk)
