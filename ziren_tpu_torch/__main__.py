"""`python -m ziren_tpu_torch` — the cargo-ziren-shaped CLI
(reference: crates/cli/src/bin/cargo-ziren.rs — execute / prove / verify /
vkey over guest ELFs).

    python -m ziren_tpu_torch execute guest.elf [--stdin-hex AABB...]
    python -m ziren_tpu_torch prove guest.elf -o proof.bin [--config core|dev]
    python -m ziren_tpu_torch verify guest.elf proof.bin [--config core|dev]
    python -m ziren_tpu_torch vkey guest.elf
    python -m ziren_tpu_torch serve [--host H] [--port P] [--config core|dev]

Each of the five takes `--device`: left out, the provers run on the GPU and
`prove` / `serve` fail at the first prove without one; `--device cpu` asks
for the CPU.

`verify` re-derives the verifying key from the ELF (vk = commitment over the
preprocessed traces), so the proof file alone plus the guest binary suffice.
`serve` runs the prover RPC service (ziren_tpu_torch/network — the reference's
GPU-container ProverService analogue, crates/cuda/proto/api.proto); point
clients at it with create_prover("network", endpoint=...).
"""

from __future__ import annotations

import argparse
import sys


def _client(config, device=None):
    from .sdk import ProverClient

    return ProverClient(config=config, device=device)


def _stdin(args):
    from .sdk import ZirenStdin

    stdin = ZirenStdin()
    for hx in args.stdin_hex or []:
        stdin.write_slice(bytes.fromhex(hx))
    return stdin


def _scaffold_guest(name: str) -> int:
    """`new` — a minimal guest crate in the reference template's shape
    (cargo-ziren.rs `new`: program + host pair; the program builds with
    the zkm toolchain when one is installed)."""
    import os

    if os.path.exists(name):
        print(f"error: {name} already exists", file=sys.stderr)
        return 1
    prog = os.path.join(name, "program")
    os.makedirs(os.path.join(prog, "src"))
    with open(os.path.join(prog, "Cargo.toml"), "w") as f:
        f.write(
            '[package]\nname = "%s-program"\nversion = "0.1.0"\n'
            'edition = "2021"\n\n[dependencies]\n'
            'zkm-zkvm = "1.2"\n' % name
        )
    with open(os.path.join(prog, "src", "main.rs"), "w") as f:
        f.write(
            "#![no_main]\n"
            "zkm_zkvm::entrypoint!(main);\n\n"
            "pub fn main() {\n"
            "    let n = zkm_zkvm::io::read::<u32>();\n"
            "    let (mut a, mut b) = (0u64, 1u64);\n"
            "    for _ in 0..n { let c = a.wrapping_add(b); a = b; b = c; }\n"
            "    zkm_zkvm::io::commit(&(b as u32));\n"
            "}\n"
        )
    with open(os.path.join(name, "host.py"), "w") as f:
        f.write(
            "from ziren_tpu_torch.guest import BincodeWriter, build_program\n"
            "from ziren_tpu_torch.sdk import ProverClient, ZirenStdin\n\n"
            'elf_path = build_program("program")\n'
            "client = ProverClient()\n"
            'pk, vk = client.setup(open(elf_path, "rb").read())\n'
            "stdin = ZirenStdin()\n"
            "stdin.write_slice(BincodeWriter().u32(10).getvalue())\n"
            "proof = client.prove(pk, stdin)\n"
            "client.verify(proof, vk)\n"
            'print("committed:", proof.public_values.as_bytes().hex())\n'
        )
    print(f"scaffolded guest project at ./{name} "
          "(program/ builds via `python -m ziren_tpu_torch build program`)")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ziren_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("execute", "prove", "verify", "vkey"):
        p = sub.add_parser(name)
        p.add_argument("elf")
        p.add_argument("--config", default="core", choices=["core", "dev"])
        p.add_argument("--stdin-hex", action="append",
                       help="hex-encoded input buffer (repeatable)")
        p.add_argument("--device", default=None,
                       help="where the prover runs: the GPU when left out, "
                            "or cpu")
        if name == "prove":
            p.add_argument("-o", "--output", default="proof.bin")
            p.add_argument("--shard-size", type=int, default=None)
        if name == "verify":
            p.add_argument("proof")
    srv = sub.add_parser("serve")
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=3000)
    srv.add_argument("--config", default="core", choices=["core", "dev"])
    srv.add_argument("--device", default=None,
                     help="where the prover runs: the GPU when left out, "
                          "or cpu")
    bld = sub.add_parser("build")  # cargo-ziren build analogue
    bld.add_argument("crate_dir")
    bld.add_argument("--features", default="")
    bld.add_argument("--elf-name", default=None)
    new = sub.add_parser("new")  # cargo-ziren new analogue
    new.add_argument("name")
    args = ap.parse_args(argv)

    if args.cmd == "build":
        from .guest.build import GuestBuildError, build_program

        try:
            path = build_program(
                args.crate_dir,
                features=[f for f in args.features.split(",") if f],
                elf_name=args.elf_name,
            )
        except GuestBuildError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(path)
        return 0

    if args.cmd == "new":
        return _scaffold_guest(args.name)

    if args.cmd == "serve":
        from .network import ProverServer

        server = ProverServer(host=args.host, port=args.port,
                              config=args.config, device=args.device)
        print(f"prover service listening on {server.endpoint}", flush=True)
        try:
            server.start()._thread.join()
        except KeyboardInterrupt:
            server.stop()
        return 0

    elf = open(args.elf, "rb").read()
    client = _client(args.config, args.device)

    if args.cmd == "execute":
        pv, report = client.execute(elf, _stdin(args))
        print(f"cycles: {report.total_instruction_count}")
        print(f"exit_code: {report.exit_code}")
        if report.stdout:
            sys.stdout.write(report.stdout.decode("utf-8", "replace"))
        if pv.words:
            print(f"committed: {pv.as_bytes().hex()}")
        return 0

    if args.cmd == "vkey":
        pk, vk = client.setup(elf)
        import numpy as np

        print("vk: " + bytes(
            np.asarray(vk.vk.commit, np.uint32).tobytes()
        ).hex())
        return 0

    if args.cmd == "prove":
        from .stark.serialize import serialize_machine_proof

        pk, vk = client.setup(elf)
        proof = client.prove(pk, _stdin(args), shard_size=args.shard_size)
        blob = serialize_machine_proof(proof.proof)
        with open(args.output, "wb") as f:
            f.write(blob)
        print(f"proof: {args.output} ({len(blob)} bytes, "
              f"{len(proof.proof.shard_proofs)} shard(s))")
        if proof.public_values.words:
            print(f"committed: {proof.public_values.as_bytes().hex()}")
        return 0

    if args.cmd == "verify":
        from .stark.serialize import deserialize_machine_proof

        pk, vk = client.setup(elf)
        from .sdk import ZirenProofWithPublicValues, PublicValuesStream

        mp = deserialize_machine_proof(open(args.proof, "rb").read())
        # no claimed public values when verifying a proof file alone: the
        # digest is read FROM the (now verified) proof
        wrapped = ZirenProofWithPublicValues(mp, None)
        client.verify(wrapped, vk)
        pv = mp.shard_proofs[-1].public_values
        digest = bytes(int(pv[i]) & 0xFF for i in range(32))
        print(f"verification: ok (committed_value_digest: {digest.hex()})")
        return 0


if __name__ == "__main__":
    sys.exit(main())
