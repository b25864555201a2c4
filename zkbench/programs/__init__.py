"""Seeded guest programs, one file a guest, found by the name a
configuration gives under "guest". Each module has

    build(asm, **args) -> Program    the guest, built with the `asm` module given
    inputs(rng, **args) -> [bytes]   one request's stdin buffers, from a numpy Generator

The program is fixed by the configuration; every request reads inputs of its
own through HINT_READ, so no two requests of a run prove the same execution.
What the guest must output is the reference's (reference/<guest>.py)."""
