"""ziren_tpu_torch: the zkVM shard prover of `ziren_tpu`, in PyTorch.

The port proves MIPS shards on an NVIDIA GPU with the same protocol as the
JAX package, and its proofs are bit-identical to the host prover's. It
stands alone: it imports torch and numpy, never JAX and never `ziren_tpu`.
The host layers are its own copies of the JAX package's files, with only
the imports rewritten; the device layers are ported:

  core/, executor/, machine/    copies: field, Poseidon2, executor, the
                                MIPS machine and its chips
  stark/{chip,config,domain,folder,lookup,opts,pcs,permutation,proof,
         prover,serialize,verifier}.py
                                copies: the host STARK prover and verifier
  stark/shape.py       the shape system (copy), and the port's own
                       record_traces: the one place a record's traces are
                       made, natural or padded, and kept for the provers
  stark/machine.py     StarkMachine (copy) and prove(machine, pk, records,
                       device=None), the one shard loop: None is the GPU,
                       "cpu" the plain versions; devices=: shards in turn
                       over a mesh's members; each shard eager or, under
                       ZIREN_FUSED=1, through stark/tfused.py
  stark/carry.py       prover state in and out as numpy arrays and bytes
  ops/tfield.py        KoalaBear + ext4 arithmetic on canonical int64 tensors
  ops/tposeidon2.py    Poseidon2 permutation / sponge / compress / tree levels
  ops/tchallenger.py   duplex challenger + proof-of-work grind on device
  ops/tpcs.py          coset LDE, Merkle MMCS, opening contractions, FRI fold
  stark/tfolder.py     LogUp permutation-trace and quotient folders
  stark/tprover.py     the per-shard device prover (one device body) and
                       proof assembly
  stark/tfused.py      the shard body as one CUDA graph per shard shape and
                       mesh member (ZIREN_FUSED=1): dispatch_fused
  device.py            the mesh: members, each a device and its own stream
  stark/ici.py         one commit's rows over a mesh, and the four-step NTT
  kernels.py           the hand-written CUDA kernels (csrc/poseidon2.cu):
                       K1 hash_rows, K2 permute, K3 compress_levels, K4 grind
  ops/kplans.py        K3's and K4's launch plans, and their plain executors
  core/septic_native.py  the Global chip's septic-curve running sum in one
                       host call (csrc/septic_sum.cpp, built by g++)
  tools/kernel_bench.py  checks and times the kernels on a GPU

Field elements are canonical int64 values in [0, p). Every function takes
its device from its tensor arguments or a `device` argument whose default
is the GPU; there is no global backend switch.
"""
