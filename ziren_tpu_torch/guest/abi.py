"""The guest<->host ABI contract, as code.

Three sub-contracts (reference files cited per section):

1. **fd map** — the WRITE syscall multiplexes on the fd argument
   (crates/primitives/src/consts.rs:10-61). fds 0-2 are POSIX-shaped;
   3 appends to the public-values stream; 4 appends a hint buffer readable
   back through HINT_LEN/HINT_READ; 5+ invoke registered host hooks whose
   result buffers are pushed onto the hint stream
   (crates/core/executor/src/hook.rs).

2. **hint-stream framing** — `io::read` lowers to `read_vec_raw`
   (crates/zkvm/entrypoint/src/lib.rs:58-120): SYSHINTLEN returns the next
   buffer's byte length (u32::MAX = exhausted), the guest allocates
   `hint_capacity(len)` bytes (len rounded up to a 4-byte multiple) and
   SYSHINTREAD copies the buffer to that word-aligned pointer; the written
   words become the deterministic init values of that memory
   (crates/core/executor/src/syscalls/hint.rs). One host `write`d buffer ==
   one guest `read`, in FIFO order.

3. **commit layout** — `io::commit` bincode-serializes the value onto the
   public-values stream (fd 3, crates/zkvm/lib/src/io.rs:85-97); at halt
   the entrypoint computes sha256 of the whole stream and COMMITs it as 8
   little-endian u32 words into PublicValues.committed_value_digest
   (crates/zkvm/entrypoint/src/lib.rs entrypoint! / zkm-lib commit path).

The typed layer (`io::read::<T>` / `commit::<T>`) is bincode with fixint
little-endian encoding; `BincodeWriter`/`BincodeReader` cover the subset
guests use (ints, bools, bytes, strings, vecs, options, tuples/structs as
field concatenation).
"""

from __future__ import annotations

import hashlib
import struct

# crates/primitives/src/consts.rs:10-61
FD_STDIN = 0
FD_STDOUT = 1
FD_STDERR = 2
FD_PUBLIC_VALUES = 3
FD_HINT = 4
FD_ECRECOVER_HOOK = 5
FD_EDDECOMPRESS = 6
FD_FP_SQRT = 7
FD_FP_INV = 8
FD_BLS12_381_SQRT = 9
FD_BLS12_381_INVERSE = 10

# SYSHINTLEN sentinel for an exhausted input stream
# (crates/zkvm/entrypoint/src/lib.rs:68-71)
HINT_EXHAUSTED = 0xFFFFFFFF


def hint_capacity(length: int) -> int:
    """Guest-side allocation size for a hint buffer: the read pointer must
    be word-aligned and whole words are written
    (crates/zkvm/entrypoint/src/lib.rs:73-75)."""
    return (length + 3) // 4 * 4


def commit_digest_words(public_values_stream: bytes) -> list:
    """The 8 u32 words the guest COMMITs at halt: sha256 of the stream,
    split little-endian (executor mirrors this; verify.rs binds the words
    into every shard's public values)."""
    d = hashlib.sha256(bytes(public_values_stream)).digest()
    return [struct.unpack("<I", d[4 * i : 4 * i + 4])[0] for i in range(8)]


class BincodeWriter:
    """bincode (fixint, little-endian) encoder for guest `io::read` inputs.

    Matches serde's derived layouts: numbers little-endian at full width,
    bool as one byte, Vec/String u64-length-prefixed, Option as 0/1 tag,
    fixed arrays and structs as plain concatenation."""

    def __init__(self):
        self.buf = bytearray()

    def _pack(self, fmt, v):
        self.buf.extend(struct.pack(fmt, v))
        return self

    def u8(self, v):
        return self._pack("<B", v)

    def u16(self, v):
        return self._pack("<H", v)

    def u32(self, v):
        return self._pack("<I", v)

    def u64(self, v):
        return self._pack("<Q", v)

    def i32(self, v):
        return self._pack("<i", v)

    def i64(self, v):
        return self._pack("<q", v)

    def boolean(self, v):
        return self.u8(1 if v else 0)

    def raw(self, data: bytes):
        self.buf.extend(data)
        return self

    def byte_vec(self, data: bytes):
        self.u64(len(data))
        return self.raw(bytes(data))

    def string(self, s: str):
        return self.byte_vec(s.encode())

    def u32_vec(self, values):
        self.u64(len(values))
        for v in values:
            self.u32(v)
        return self

    def option(self, value, write_fn):
        if value is None:
            return self.u8(0)
        self.u8(1)
        write_fn(value)
        return self

    def getvalue(self) -> bytes:
        return bytes(self.buf)


class BincodeReader:
    """Decoder twin of BincodeWriter (for host-side inspection of
    committed public-values streams)."""

    def __init__(self, data: bytes):
        self.data = bytes(data)
        self.off = 0

    def _unpack(self, fmt, size):
        v = struct.unpack_from(fmt, self.data, self.off)[0]
        self.off += size
        return v

    def u8(self):
        return self._unpack("<B", 1)

    def u16(self):
        return self._unpack("<H", 2)

    def u32(self):
        return self._unpack("<I", 4)

    def u64(self):
        return self._unpack("<Q", 8)

    def i32(self):
        return self._unpack("<i", 4)

    def i64(self):
        return self._unpack("<q", 8)

    def boolean(self):
        return self.u8() != 0

    def raw(self, n: int) -> bytes:
        v = self.data[self.off : self.off + n]
        if len(v) != n:
            raise ValueError("bincode: truncated input")
        self.off += n
        return v

    def byte_vec(self) -> bytes:
        return self.raw(self.u64())

    def string(self) -> str:
        return self.byte_vec().decode()

    def u32_vec(self):
        return [self.u32() for _ in range(self.u64())]

    def option(self, read_fn):
        tag = self.u8()
        if tag == 0:
            return None
        if tag != 1:
            raise ValueError("bincode: bad Option tag")
        return read_fn()

    def done(self) -> bool:
        return self.off == len(self.data)
