"""The plain reference: what each request must output, worked out again from
its inputs in plain Python (one file a guest, `<guest>.py`, with
`expected(buffers, **args) -> {"words": [...], "cycles": n}`), and the
verifier that judges the proofs (`verify.py`, over `zkvm/`, a frozen copy of
the port's host STARK verifier). Nothing here imports jax, ziren_tpu or
ziren_tpu_torch."""
