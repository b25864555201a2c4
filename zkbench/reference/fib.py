"""What programs/fib.py outputs: the recurrence mod 2^32 from the pair read
from stdin, and its cycle count, one cycle an instruction:
8 before the loop (HINT_READ's four, the base, two loads, the counter),
6 a step, 4 to commit and 3 to halt."""

from __future__ import annotations


def expected(buffers, n: int) -> dict:
    (buf,) = buffers
    a, b = int.from_bytes(buf[0:4], "little"), int.from_bytes(buf[4:8], "little")
    for _ in range(n):
        a, b = b, (a + b) & 0xFFFFFFFF
    return {"words": [b], "cycles": 8 + 6 * n + 4 + 3}
