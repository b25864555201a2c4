"""Guest-side ABI layer (reference L3: crates/zkvm/{entrypoint,lib},
crates/build, crates/cli).

The MIPS guest binary itself is ISA-bound Rust/Go compiled by the
reference's `mipsel-zkm-zkvm-elf` toolchain — this environment has no Rust,
so what lives here is the CONTRACT both sides of the syscall boundary obey,
as code + tests rather than implicit executor behavior:

  * `abi`    — fd map, hint-stream framing, commit layout, and a
               bincode-compatible codec for typed `io::read/commit` values;
  * `build`  — the `cargo ziren build` driver analogue: shells out to the
               MIPS toolchain when one is installed, resolves prebuilt
               ELFs otherwise (`include_elf!` analogue).
"""

from .abi import (
    FD_BLS12_381_INVERSE,
    FD_BLS12_381_SQRT,
    FD_ECRECOVER_HOOK,
    FD_EDDECOMPRESS,
    FD_FP_INV,
    FD_FP_SQRT,
    FD_HINT,
    FD_PUBLIC_VALUES,
    FD_STDERR,
    FD_STDIN,
    FD_STDOUT,
    HINT_EXHAUSTED,
    BincodeReader,
    BincodeWriter,
    commit_digest_words,
    hint_capacity,
)
from .build import GuestBuildError, build_program, find_toolchain, include_elf

__all__ = [
    "FD_STDIN", "FD_STDOUT", "FD_STDERR", "FD_PUBLIC_VALUES", "FD_HINT",
    "FD_ECRECOVER_HOOK", "FD_EDDECOMPRESS", "FD_FP_SQRT", "FD_FP_INV",
    "FD_BLS12_381_SQRT", "FD_BLS12_381_INVERSE", "HINT_EXHAUSTED",
    "BincodeReader", "BincodeWriter", "commit_digest_words", "hint_capacity",
    "GuestBuildError", "build_program", "find_toolchain", "include_elf",
]
