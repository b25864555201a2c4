"""Walkthroughs of the port as a user drives it: precompile guests, a remote
prover behind the signed RPC, and a guest ELF from execution to a
compressed proof. Each runs as `python -m ziren_tpu_torch.examples.<name>`,
on the GPU unless `--device` names the CPU or the host numpy prover."""
