"""Guest build driver — the `zkm-build` / `cargo ziren build` analogue
(reference crates/build/src/lib.rs:21-121, crates/cli/src/bin/
cargo-ziren.rs:21-36).

The reference drives cargo with a pinned `zkm` rustup toolchain targeting
`mipsel-zkm-zkvm-elf`. This environment ships no Rust toolchain, so the
driver degrades explicitly: `find_toolchain()` probes for one and
`build_program` raises `GuestBuildError` (callers/tests skip) when absent;
`include_elf` resolves prebuilt guest ELFs the way the reference's
`include_elf!` macro bakes them in."""

from __future__ import annotations

import os
import shutil
import subprocess

TARGET = "mipsel-zkm-zkvm-elf"
TOOLCHAIN = "zkm"


class GuestBuildError(RuntimeError):
    pass


def find_toolchain():
    """Probe for a usable guest toolchain. Returns {"cargo": path,
    "toolchain": name} or None. Honors ZIREN_GUEST_CARGO /
    ZIREN_GUEST_TOOLCHAIN overrides."""
    cargo = os.environ.get("ZIREN_GUEST_CARGO") or shutil.which("cargo")
    if cargo is None:
        return None
    toolchain = os.environ.get("ZIREN_GUEST_TOOLCHAIN", TOOLCHAIN)
    rustup = shutil.which("rustup")
    if rustup is not None:
        try:
            out = subprocess.run(
                [rustup, "toolchain", "list"], capture_output=True,
                text=True, timeout=30,
            ).stdout
            if toolchain not in out:
                return None
        except Exception:
            return None
    return {"cargo": cargo, "toolchain": toolchain}


def build_program(crate_dir: str, features=(), release: bool = True,
                  elf_name: str | None = None) -> str:
    """Build a guest crate for the zkVM target; returns the ELF path
    (reference build_program_with_args, build/src/lib.rs:108-121)."""
    tc = find_toolchain()
    if tc is None:
        raise GuestBuildError(
            f"no `{TOOLCHAIN}` rust toolchain with the {TARGET} target is "
            "installed (see the reference's cargo-ziren installer)"
        )
    cmd = [tc["cargo"], f"+{tc['toolchain']}", "build", "--target", TARGET]
    if release:
        cmd.append("--release")
    if features:
        cmd += ["--features", ",".join(features)]
    env = dict(os.environ)
    # reference build/src/lib.rs: guests build with a locked minimal std
    env.setdefault(
        "CARGO_ENCODED_RUSTFLAGS", "\x1f".join(["-C", "passes=lower-atomic"])
    )
    proc = subprocess.run(
        cmd, cwd=crate_dir, env=env, capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise GuestBuildError(
            f"cargo build failed rc={proc.returncode}:\n{proc.stderr[-2000:]}"
        )
    profile = "release" if release else "debug"
    out_dir = os.path.join(crate_dir, "target", TARGET, profile)
    if elf_name is not None:
        path = os.path.join(out_dir, elf_name)
        if os.path.exists(path):
            return path
        raise GuestBuildError(f"built, but {path} not found")
    elfs = [
        os.path.join(out_dir, f)
        for f in (os.listdir(out_dir) if os.path.isdir(out_dir) else [])
        if os.path.isfile(os.path.join(out_dir, f))
        and not f.endswith((".d", ".rlib"))
    ]
    if len(elfs) != 1:
        raise GuestBuildError(f"expected one ELF in {out_dir}, got {elfs}")
    return elfs[0]


_ELF_SEARCH = (
    "{root}/elf/{name}",
    "{root}/{name}",
)


def include_elf(name: str, root: str | None = None) -> bytes:
    """Resolve a prebuilt guest ELF by name (`include_elf!` analogue,
    reference build/src/lib.rs:21-40). Search order: ZIREN_ELF_PATH dir,
    then the caller-supplied root (its elf/ directory first). Nothing outside
    those two is searched: a checkout of the reference's artifacts is named
    through ZIREN_ELF_PATH."""
    candidates = []
    envdir = os.environ.get("ZIREN_ELF_PATH")
    if envdir:
        candidates.append(os.path.join(envdir, name))
    for pat in _ELF_SEARCH:
        if "{root}" in pat:
            if root is None:
                continue
            candidates.append(pat.format(root=root, name=name))
        else:
            candidates.append(pat.format(name=name))
    for path in candidates:
        if os.path.isfile(path):
            with open(path, "rb") as f:
                return f.read()
    raise FileNotFoundError(
        f"guest ELF {name!r} not found; searched {candidates}"
    )
