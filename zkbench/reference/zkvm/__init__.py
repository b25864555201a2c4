"""A frozen copy of the port's host STARK verifier and the MIPS machine's
AIRs, from ziren_tpu_torch/ at commit 88d1ffc: core/ (field, extension,
Poseidon2, Merkle, NTT, septic), executor/ (instruction, opcode, program,
record, asm and the executor module that the SHA chips read constants from),
machine/ (every chip of the MIPS machine) and stark/ (chip, config, domain,
folder, lookup, opts, pcs, permutation, proof, serialize, verifier, machine).

The files are the port's, imports unchanged (relative), but for four edits:
  core/p2_native.py      a stub whose available() is False: the numpy paths
                         run, and no native library is built
  executor/__init__.py   empty: the executor is not re-exported
  stark/machine.py       StarkMachine keeps setup and verify; the device
                         prover paths are cut
  machine/mips.py        keeps mips_airs, mips_machine and
                         verify_mips_proof; the execute and prove helpers are cut
Nothing here imports torch, jax, ziren_tpu or ziren_tpu_torch."""
