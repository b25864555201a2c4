"""ziren_tpu_torch: the device shard prover of `ziren_tpu`, in PyTorch.

The port proves MIPS shards on an NVIDIA GPU with the same protocol as the
JAX package, and its proofs are bit-identical to the host prover's
(`ziren_tpu.stark.prover.prove_shard`). It shares every host layer with
`ziren_tpu` (executor, machine, trace generation, shapes, proof types,
verifier) and ports only the device layer:

  ops/tfield.py        KoalaBear + ext4 arithmetic on canonical int64 tensors
  ops/tposeidon2.py    Poseidon2 permutation / sponge / compress
  ops/tchallenger.py   duplex challenger + proof-of-work grind on device
  ops/tpcs.py          coset LDE, Merkle MMCS, opening contractions, FRI fold
  stark/tfolder.py     LogUp permutation-trace and quotient folders
  stark/tprover.py     the per-shard device prover and proof assembly
  stark/machine.py     prove(machine, pk, records, device=...)
  kernels.py           the hand-written CUDA kernels (csrc/poseidon2.cu)

Field elements are canonical int64 values in [0, p). Every function takes
its device from its tensor arguments or an explicit `device` argument;
there is no global backend switch. The package never imports JAX.
"""
