"""Circuit-artifact install flow (reference: crates/sdk/src/install.rs).

The reference lazily downloads versioned Groth16/Plonk circuit artifacts
(proving key, verifying key, contract sources) from a bucket into
`~/.zkm/circuits/<type>/<version>` and reuses them forever. Same shape
here, adapted to air-gapped deployments:

  * artifacts live under `~/.ziren/circuits/<type>/<version>`
    (ZIREN_CIRCUITS_DIR overrides the root);
  * `try_install_circuit_artifacts` fetches `<base>/<type>/<version>.tar.gz`
    from ZIREN_ARTIFACTS_URL — http(s), file:// or a plain directory path —
    verifying an optional sha256 (`<archive>.sha256` next to it, or
    ZIREN_ARTIFACTS_SHA256), then extracts;
  * `pack_circuit_artifacts` produces the archive + checksum from a built
    artifact dir (the publisher half the reference keeps in its release
    tooling).

The tar extraction refuses path traversal (no absolute names, no `..`) —
the artifact server is semi-trusted at best.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tarfile
import tempfile
import urllib.request

CIRCUIT_VERSION = "v1"


class InstallError(RuntimeError):
    pass


def circuits_root() -> str:
    return os.environ.get(
        "ZIREN_CIRCUITS_DIR",
        os.path.join(os.path.expanduser("~"), ".ziren", "circuits"),
    )


def circuit_artifacts_dir(artifacts_type: str,
                          version: str = CIRCUIT_VERSION) -> str:
    if artifacts_type not in ("groth16", "plonk"):
        raise InstallError(f"unsupported artifacts type: {artifacts_type}")
    return os.path.join(circuits_root(), artifacts_type, version)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fetch(url: str, dst: str) -> None:
    if "://" not in url:  # plain directory / file path
        shutil.copyfile(url, dst)
        return
    with urllib.request.urlopen(url, timeout=600) as resp, \
            open(dst, "wb") as f:
        shutil.copyfileobj(resp, f)


def _safe_extract(archive: str, dest: str) -> None:
    with tarfile.open(archive, "r:*") as tar:
        for m in tar.getmembers():
            name = m.name
            if name.startswith("/") or ".." in name.split("/"):
                raise InstallError(f"unsafe path in artifact archive: {name}")
            if m.issym() or m.islnk():
                raise InstallError(f"link in artifact archive: {name}")
        tar.extractall(dest)


def try_install_circuit_artifacts(artifacts_type: str,
                                  version: str = CIRCUIT_VERSION) -> str:
    """Return the artifact dir, fetching + extracting it if absent
    (reference install.rs try_install_circuit_artifacts)."""
    build_dir = circuit_artifacts_dir(artifacts_type, version)
    if os.path.isdir(build_dir) and os.listdir(build_dir):
        return build_dir
    base = os.environ.get("ZIREN_ARTIFACTS_URL")
    if not base:
        raise InstallError(
            f"{artifacts_type} circuit artifacts not installed at "
            f"{build_dir} and no ZIREN_ARTIFACTS_URL configured; build them "
            "locally (sdk wrap setup) or point at an artifact mirror"
        )
    name = f"{artifacts_type}-{version}.tar.gz"
    sep = "/" if "://" in base else os.sep
    url = base.rstrip("/") + sep + name
    with tempfile.TemporaryDirectory() as td:
        archive = os.path.join(td, name)
        _fetch(url, archive)
        want = os.environ.get("ZIREN_ARTIFACTS_SHA256")
        if want is None:
            try:
                sump = os.path.join(td, name + ".sha256")
                _fetch(url + ".sha256", sump)
                with open(sump) as f:
                    want = f.read().split()[0]
            except Exception:
                want = None  # no checksum published
        if want is not None and _sha256(archive) != want.lower():
            raise InstallError(f"artifact checksum mismatch for {name}")
        tmp_dir = build_dir + ".tmp"
        shutil.rmtree(tmp_dir, ignore_errors=True)
        os.makedirs(tmp_dir, exist_ok=True)
        _safe_extract(archive, tmp_dir)
        os.makedirs(os.path.dirname(build_dir), exist_ok=True)
        shutil.rmtree(build_dir, ignore_errors=True)
        os.replace(tmp_dir, build_dir)
    return build_dir


def pack_circuit_artifacts(src_dir: str, out_dir: str, artifacts_type: str,
                           version: str = CIRCUIT_VERSION) -> str:
    """Publisher half: archive a built artifact dir + write its sha256.
    Returns the archive path."""
    os.makedirs(out_dir, exist_ok=True)
    name = f"{artifacts_type}-{version}.tar.gz"
    archive = os.path.join(out_dir, name)
    with tarfile.open(archive, "w:gz") as tar:
        for entry in sorted(os.listdir(src_dir)):
            tar.add(os.path.join(src_dir, entry), arcname=entry)
    with open(archive + ".sha256", "w") as f:
        f.write(_sha256(archive) + "  " + name + "\n")
    return archive
