"""The port's host modules behind the SDK (ziren_tpu_torch.snark, verifier,
guest, install, stark/interop, stark/picus, machine/debug) against the JAX
package's, on the CPU, tolerance 0: proofs, keys, contracts and exports are
compared as bytes or text, and each package's verifier takes the other's
bytes. The inputs are a small R1CS (as tests/test_groth16.py builds one), a
cubic circuit (tests/test_plonk.py), seeded numpy values, and dev-config
proofs that each package makes itself."""

import hashlib
import os

import numpy as np
import pytest
import torch

import ziren_tpu.executor.asm as jasm
import ziren_tpu.guest as jguest
import ziren_tpu.machine.debug as jdebug
import ziren_tpu.machine.mips as jmips
import ziren_tpu.snark as jsnark
import ziren_tpu.snark.circuit as jcircuit
import ziren_tpu.snark.contract as jcontract
import ziren_tpu.snark.plonk as jplonk
import ziren_tpu.stark.config as jconfig
import ziren_tpu.stark.interop as jinterop
import ziren_tpu.stark.picus as jpicus
import ziren_tpu.stark.serialize as jser
import ziren_tpu.verifier as jverifier
import ziren_tpu.verifier.plonk as jvplonk
import ziren_tpu_torch.executor.asm as tasm
import ziren_tpu_torch.guest as tguest
import ziren_tpu_torch.machine.debug as tdebug
import ziren_tpu_torch.machine.mips as tmips
import ziren_tpu_torch.snark as tsnark
import ziren_tpu_torch.snark.circuit as tcircuit
import ziren_tpu_torch.snark.contract as tcontract
import ziren_tpu_torch.snark.plonk as tplonk
import ziren_tpu_torch.stark.config as tconfig
import ziren_tpu_torch.stark.interop as tinterop
import ziren_tpu_torch.stark.picus as tpicus
import ziren_tpu_torch.stark.serialize as tser
import ziren_tpu_torch.verifier as tverifier
import ziren_tpu_torch.verifier.plonk as tvplonk
from ziren_tpu import install as jinstall
from ziren_tpu.verifier import bn254_pairing as jbp
from ziren_tpu.verifier.groth16 import Groth16Error as JGroth16Error
from ziren_tpu_torch import install as tinstall
from ziren_tpu_torch.sdk import ProverClient
from ziren_tpu_torch.verifier import bn254_pairing as tbp
from ziren_tpu_torch.verifier.groth16 import Groth16Error as TGroth16Error

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SEED = b"seeded-for-both-packages"
CHIPS = [c.name for c in tmips.mips_machine().chips]


def _r1cs(snark):
    # x*y = z and (x+y)*1 = s, publics (z, s); wires [1, z, s, x, y]
    return snark.R1CS(num_wires=5, num_public=2, a=[{3: 1}, {3: 1, 4: 1}],
                      b=[{4: 1}, {0: 1}], c=[{1: 1}, {2: 1}])


@pytest.fixture(scope="module")
def groth16():
    out = {}
    for key, snark in (("j", jsnark), ("t", tsnark)):
        pk = snark.setup(_r1cs(snark), seed=SEED)
        out[key] = (snark.prove(pk, [1, 77, 18, 7, 11]), pk.vk_bytes)
    return out


def test_groth16_proof_and_vk_are_byte_equal(groth16):
    (jproof, jvk), (tproof, tvk) = groth16["j"], groth16["t"]
    assert tproof == jproof and len(tproof) == 324  # gnark WriteTo layout, no commitments
    assert tvk == jvk
    other = tsnark.setup(_r1cs(tsnark), seed=b"another seed")
    assert other.vk_bytes != tvk


def test_each_groth16_verifier_accepts_the_others_proof(groth16):
    (jproof, jvk), (tproof, tvk) = groth16["j"], groth16["t"]
    assert tverifier.Groth16Verifier.verify_gnark_proof(jproof[:256], [77, 18], jvk)
    assert jverifier.Groth16Verifier.verify_gnark_proof(tproof[:256], [77, 18], tvk)
    assert ProverClient.groth16_verify({"proof": jproof[:256], "public_inputs": [77, 18],
                                        "vk_bytes": jvk})
    for verifier, err in ((tverifier, TGroth16Error), (jverifier, JGroth16Error)):
        with pytest.raises(err):
            verifier.Groth16Verifier.verify_gnark_proof(tproof[:256], [78, 18], tvk)
        bad = bytearray(tproof)
        bad[5] ^= 1
        with pytest.raises(err):
            verifier.Groth16Verifier.verify_gnark_proof(bytes(bad[:256]), [77, 18], tvk)


def test_the_ziren_verify_entry_is_the_same():
    """The 4-byte vk-hash prefix and [vkey_hash, sha256(public values)]
    public inputs (tests/test_groth16.py:test_ziren_verify_entry)."""
    from ziren_tpu.verifier.groth16 import hash_public_inputs as jhash
    from ziren_tpu_torch.verifier.groth16 import hash_public_inputs as thash

    stream, vkey_hash = b"hello ziren", bytes(32)
    assert thash(stream) == jhash(stream)
    digest = int.from_bytes(thash(stream), "big")
    vkey = int.from_bytes(vkey_hash[1:], "big")
    blobs = []
    for snark in (jsnark, tsnark):
        pk = snark.setup(snark.R1CS(num_wires=5, num_public=2, a=[{1: 1}, {2: 1}],
                                    b=[{0: 1}, {0: 1}], c=[{3: 1}, {4: 1}]), seed=SEED)
        proof = snark.prove(pk, [1, vkey, digest, vkey, digest])
        blobs.append((hashlib.sha256(pk.vk_bytes).digest()[:4] + proof, pk.vk_bytes))
    assert blobs[0] == blobs[1]
    prefixed, vk_bytes = blobs[1]
    for verifier, err in ((tverifier, TGroth16Error), (jverifier, JGroth16Error)):
        assert verifier.Groth16Verifier.verify(prefixed, stream, "0x" + vkey_hash.hex(), vk_bytes)
        with pytest.raises(err):
            verifier.Groth16Verifier.verify(prefixed, b"other", "0x" + vkey_hash.hex(), vk_bytes)


def test_the_exported_contract_is_the_same_text(groth16):
    (_jproof, jvk), (_tproof, tvk) = groth16["j"], groth16["t"]
    text = tcontract.export_solidity(tvk, name="Held")
    assert text == jcontract.export_solidity(jvk, name="Held")
    assert "contract Held" in text and "ziren_tpu.snark.contract.export_solidity" in text
    assert ProverClient.export_verifier_contract({"vk_bytes": tvk}, name="Held") == text


def _cubic(circuit, x_val=3):
    """x^3 + x + 5 == out, out public (tests/test_plonk.py)."""
    bld = circuit.CircuitBuilder()
    out = bld.public(x_val**3 + x_val + 5)
    x = bld.wit(x_val)
    x3 = bld.mul(bld.mul(x, x), x)
    bld.assert_zero_var(x3 + x + bld.const(5) - out)
    assert bld.check()
    return bld


@pytest.fixture(scope="module")
def plonk():
    out = {}
    for key, circuit, pl in (("j", jcircuit, jplonk), ("t", tcircuit, tplonk)):
        bld = _cubic(circuit)
        cs, publics = pl.from_r1cs(bld.to_r1cs(), bld.witness)
        pk = pl.setup(cs, seed=SEED)
        out[key] = (pl.prove(pk, publics), pk.vk_bytes, publics)
    return out


def test_plonk_proof_and_vk_are_byte_equal(plonk):
    assert plonk["t"] == plonk["j"]
    proof, vk_bytes, publics = plonk["t"]
    assert len(proof) == 768 and publics == [35]
    assert tvplonk.load_vk(vk_bytes).nb_public == 1


def test_each_plonk_verifier_accepts_the_others_proof(plonk):
    (jproof, jvk, jpub), (tproof, tvk, tpub) = plonk["j"], plonk["t"]
    assert tvplonk.verify_plonk(jproof, jvk, jpub) and jvplonk.verify_plonk(tproof, tvk, tpub)
    for vp in (tvplonk, jvplonk):
        with pytest.raises(vp.PlonkError):
            vp.verify_plonk(tproof, tvk, [tpub[0] + 1])
    assert ProverClient.plonk_verify({"proof": tproof, "vk_bytes": tvk, "public_inputs": tpub})


def test_the_pairing_is_the_same():
    rng = np.random.default_rng(254)
    g1 = (1, 2)
    for bp in (jbp, tbp):
        assert bp.is_on_g1(g1)
    for k in (int(v) for v in rng.integers(2, 1 << 62, 3)):
        assert tbp.g1_mul(g1, k) == jbp.g1_mul(g1, k)
        assert tbp.g1_neg(tbp.g1_mul(g1, k)) == jbp.g1_neg(jbp.g1_mul(g1, k))


def test_the_circuit_builder_gives_the_same_r1cs():
    jr, tr = _cubic(jcircuit).to_r1cs(), _cubic(tcircuit).to_r1cs()
    assert (tr.num_wires, tr.num_public) == (jr.num_wires, jr.num_public)
    assert (tr.a, tr.b, tr.c) == (jr.a, jr.b, jr.c)
    assert _cubic(tcircuit).witness == _cubic(jcircuit).witness


@pytest.fixture(scope="module")
def mips30():
    """fibonacci(30) at the dev config, set up and proved by each package."""
    out = {}
    for key, asm, mips, config, kw in (("j", jasm, jmips, jconfig, {}),
                                       ("t", tasm, tmips, tconfig, {"device": "cpu"})):
        program = asm.fibonacci_program(30)
        machine = mips.mips_machine(config.dev_config())
        pk, vk = machine.setup(program)
        _ex, record = mips.execute(program)
        out[key] = (machine, pk, vk, record, machine.prove(pk, [record], **kw))
    return out


def test_interop_bincode_bytes_are_equal(mips30):
    (jm, _jpk, jvk, _jr, jproof), (tm, _tpk, tvk, _tr, tproof) = mips30["j"], mips30["t"]
    tblob = tinterop.serialize_shard_proof_reference(tm, tvk, tproof.shard_proofs[0])
    assert tblob == jinterop.serialize_shard_proof_reference(jm, jvk, jproof.shard_proofs[0])
    back = tinterop.deserialize_shard_proof_reference(tm, tblob)
    assert tinterop.serialize_shard_proof_reference(tm, tvk, back) == tblob
    for v in (0, 1, 2130706432, 12345678):
        assert tinterop._monty(v) == jinterop._monty(v)
        assert tinterop._unmonty(tinterop._monty(v)) == v
    assert tinterop.encode_part_stark_vk(77, 0x1000) == jinterop.encode_part_stark_vk(77, 0x1000)
    entries = [(list(range(i, i + 8)), i) for i in range(3)]
    blob = tinterop.encode_vk_map(entries)
    assert blob == jinterop.encode_vk_map(entries)
    assert [(list(d), i) for d, i in tinterop.decode_vk_map(blob)] == entries


def test_the_portable_verifier_takes_either_packages_bytes(mips30):
    """verifier/artifacts.py: a packed vk and a serialized proof, nothing
    else, and verifier/stark.py on the objects."""
    (jm, _jpk, jvk, _jr, jproof), (tm, _tpk, tvk, _tr, tproof) = mips30["j"], mips30["t"]
    tart, jart = tverifier.pack_vk(tm, tvk), jverifier.pack_vk(jm, jvk)
    assert tart == jart
    tblob, jblob = tser.serialize_machine_proof(tproof), jser.serialize_machine_proof(jproof)
    assert tblob == jblob
    assert tverifier.verify_core_artifact(jart, jblob)
    assert jverifier.verify_core_artifact(tart, tblob)
    assert tverifier.verify_machine_proof(tm, tvk, tproof)
    assert tverifier.verify_shard_proof(tm, tvk, tproof.shard_proofs[0])
    bad = bytearray(tblob)
    bad[len(bad) // 2] ^= 1
    with pytest.raises(Exception):
        tverifier.verify_core_artifact(tart, bytes(bad))


def test_debug_helpers_agree(mips30):
    (jm, jpk, _jvk, jr, _jp), (tm, tpk, _tvk, tr, _tp) = mips30["j"], mips30["t"]
    assert tdebug.debug_constraints(tm, tpk, tr) and jdebug.debug_constraints(jm, jpk, jr)
    timb, _ = tdebug.debug_lookups(tm, tpk, tr)
    jimb, _ = jdebug.debug_lookups(jm, jpk, jr)
    assert not timb and not jimb
    for (tchip, ttrace), (jchip, jtrace) in zip(tdebug.generate_all_traces(tm, tpk, tr),
                                                jdebug.generate_all_traces(jm, jpk, jr)):
        assert tchip.name == jchip.name and np.array_equal(ttrace, jtrace)


@pytest.mark.parametrize("name", CHIPS)
def test_picus_export_is_the_same_text(name):
    jm, tm = jmips.mips_machine(), tmips.mips_machine()
    text = tpicus.export_chip(tm.chip_by_name[name], tm.num_public_values)
    assert text == jpicus.export_chip(jm.chip_by_name[name], jm.num_public_values)
    assert f"(begin-module {name})" in text and text.count("(") == text.count(")")


def test_guest_abi_is_the_same():
    rng = np.random.default_rng(7)
    vals = [int(v) for v in rng.integers(0, 1 << 32, 5)]
    blobs = []
    for guest in (jguest, tguest):
        w = guest.BincodeWriter()
        w.u8(7).u16(513).u32(vals[0]).u64(vals[1] << 20).i32(-5).i64(-(1 << 40)).boolean(True)
        w.byte_vec(b"abc").string("ziren").u32_vec(vals).option(None, None)
        blobs.append(w.getvalue())
        assert guest.commit_digest_words(b"stream") == tguest.commit_digest_words(b"stream")
        assert [guest.hint_capacity(n) for n in (0, 1, 4, 5, 4096)] == [
            tguest.hint_capacity(n) for n in (0, 1, 4, 5, 4096)]
    assert blobs[0] == blobs[1]
    r = tguest.BincodeReader(blobs[1])
    assert (r.u8(), r.u16(), r.u32(), r.u64()) == (7, 513, vals[0], vals[1] << 20)
    assert (r.i32(), r.i64(), r.boolean()) == (-5, -(1 << 40), True)
    assert (r.byte_vec(), r.string(), r.u32_vec()) == (b"abc", "ziren", vals)
    for name in tguest.__all__:
        if name.startswith("FD_") or name == "HINT_EXHAUSTED":
            assert getattr(tguest, name) == getattr(jguest, name), name
    assert tguest.find_toolchain() == jguest.find_toolchain()


def test_include_elf_searches_only_what_it_is_given(tmp_path, monkeypatch):
    """The port's include_elf reads ZIREN_ELF_PATH and the caller's root (its
    elf/ directory first), as the JAX package's does, and no fixed directory
    beyond them."""
    from chip_smoke import minimal_elf

    (tmp_path / "elf").mkdir()
    (tmp_path / "elf" / "fib").write_bytes(minimal_elf(3))
    (tmp_path / "fib").write_bytes(minimal_elf(4))
    (tmp_path / "env").mkdir()
    (tmp_path / "env" / "fib").write_bytes(minimal_elf(5))
    monkeypatch.delenv("ZIREN_ELF_PATH", raising=False)
    for guest in (jguest, tguest):
        assert guest.include_elf("fib", root=str(tmp_path)) == minimal_elf(3)
    with pytest.raises(FileNotFoundError) as e:
        tguest.include_elf("absent", root=str(tmp_path))
    assert str(e.value).count("absent") == 3  # the name, and two places under the root
    with pytest.raises(FileNotFoundError, match=r"searched \[\]"):
        tguest.include_elf("fib")
    monkeypatch.setenv("ZIREN_ELF_PATH", str(tmp_path / "env"))
    for guest in (jguest, tguest):
        assert guest.include_elf("fib", root=str(tmp_path)) == minimal_elf(5)
    assert tguest.include_elf("fib") == minimal_elf(5)


def test_install_from_a_local_mirror(tmp_path, monkeypatch):
    """tests/test_install.py's round trip through the port's copy, from a
    plain directory: nothing is fetched over a network."""
    src = tmp_path / "built"
    src.mkdir()
    (src / "wrap_pk.bin").write_bytes(b"\x01" * 64)
    (src / "wrap_vk.bin").write_bytes(b"\x02" * 32)
    tarc = tinstall.pack_circuit_artifacts(str(src), str(tmp_path / "tmirror"), "groth16")
    jarc = jinstall.pack_circuit_artifacts(str(src), str(tmp_path / "jmirror"), "groth16")
    assert os.path.basename(tarc) == os.path.basename(jarc) == "groth16-v1.tar.gz"
    monkeypatch.setenv("ZIREN_CIRCUITS_DIR", str(tmp_path / "circuits"))
    monkeypatch.setenv("ZIREN_ARTIFACTS_URL", str(tmp_path / "tmirror"))
    d = tinstall.try_install_circuit_artifacts("groth16")
    assert d == jinstall.circuit_artifacts_dir("groth16")
    assert sorted(os.listdir(d)) == ["wrap_pk.bin", "wrap_vk.bin"]
    monkeypatch.setenv("ZIREN_ARTIFACTS_URL", str(tmp_path / "gone"))
    assert tinstall.try_install_circuit_artifacts("groth16") == d  # installed: no fetch
    with open(tarc, "r+b") as f:
        f.seek(20)
        f.write(b"\xff\xff")
    monkeypatch.setenv("ZIREN_ARTIFACTS_URL", str(tmp_path / "tmirror"))
    monkeypatch.setenv("ZIREN_CIRCUITS_DIR", str(tmp_path / "empty"))
    with pytest.raises(tinstall.InstallError, match="checksum"):
        tinstall.try_install_circuit_artifacts("groth16")
    monkeypatch.delenv("ZIREN_ARTIFACTS_URL")
    with pytest.raises(tinstall.InstallError, match="ZIREN_ARTIFACTS_URL"):
        tinstall.try_install_circuit_artifacts("plonk")
    with pytest.raises(tinstall.InstallError, match="unsupported"):
        tinstall.circuit_artifacts_dir("stark")


@pytest.mark.slow
def test_the_wrap_circuit_is_the_same_r1cs():
    """build_wrap_circuit on one dev-config wrap proof that each package
    makes itself (compress -> shrink -> wrap of a plain AIR, minutes each):
    the same constraint count, public inputs and witness."""
    from test_stark_engine import FibonacciAir, Record, fib_pv
    from test_torch_folder import PortFibonacciAir

    import ziren_tpu.recursion.pipeline as jpl
    import ziren_tpu.snark.wrap_circuit as jwrap
    import ziren_tpu.stark.machine as jmachine
    import ziren_tpu_torch.recursion.pipeline as tpl
    import ziren_tpu_torch.snark.wrap_circuit as twrap
    import ziren_tpu_torch.stark.machine as tmachine

    built = []
    for machine_mod, config, air, pl, wrap, kw in (
            (jmachine, jconfig, FibonacciAir, jpl, jwrap, {}),
            (tmachine, tconfig, PortFibonacciAir, tpl, twrap, {"device": "cpu"})):
        m = machine_mod.StarkMachine(config.dev_config(), [air()], num_public_values=3)
        pk, vk = m.setup()
        proof = m.prove(pk, [Record(n=16, pv=fib_pv(16))], **kw)
        rm, rvk, final_sp = pl.compress(m, vk, proof, **kw)
        sm, svk, sproof, _ = pl.shrink(rm, rvk, final_sp, **kw)
        wm, wvk, wproof, _ = pl.wrap_bn254(sm, svk, sproof.shard_proofs[0],
                                           config=config.outer_dev_config())
        wsp = wproof.shard_proofs[0]
        bld, publics = wrap.build_wrap_circuit(wm, wvk, wsp)
        assert publics[0] == int(wvk.commit)
        assert publics[1:] == [int(v) for v in wsp.public_values]
        built.append((bld.num_constraints, bld.num_public, publics, bld.witness))
    assert built[0][0] == built[1][0] > 100_000
    assert built[0][1:3] == built[1][1:3]
    assert built[0][3] == built[1][3]
