"""What programs/sha2chain.py outputs: `rounds` rounds of SHA-256 with
hashlib over the 32 bytes read from stdin, and its cycle count, one cycle an
instruction: 31 before the loop (HINT_READ's four, two bases, the padding's
24 stores, the counter), 52 a round (16 to copy the digest, 24 to store the
IV, 9 for the two syscalls, 3 for the loop), 32 to commit and 3 to halt.

The hint lands in memory as little-endian words, and SHA-256 reads a
message word as the big-endian value of its four bytes; so the first message
is those words written big-endian, and each digest is the state's words
written big-endian."""

from __future__ import annotations

import hashlib


def expected(buffers, rounds: int) -> dict:
    (buf,) = buffers
    words = [int.from_bytes(buf[i : i + 4], "little") for i in range(0, 32, 4)]
    msg = b"".join(w.to_bytes(4, "big") for w in words)
    for _ in range(rounds):
        msg = hashlib.sha256(msg).digest()
    out = [int.from_bytes(msg[i : i + 4], "big") for i in range(0, 32, 4)]
    return {"words": out, "cycles": 31 + 52 * rounds + 32 + 3}
