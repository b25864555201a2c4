"""Wire serialization for the prover RPC (reference: crates/cuda's bincode
payloads, proto/api.proto).

The reference's bincode payloads are data-only; plain pickle would hand
anyone who can reach the port (or MITM a response) arbitrary code
execution. This module keeps pickle's convenience for our dataclass-heavy
payloads but restricts DESERIALIZATION to an allowlist: only classes from
`ziren_tpu_torch.*` plus numpy's array-reconstruction helpers resolve; every
other global (os.system, subprocess, functions in general, and every
`torch.*` name: a payload holds numpy arrays, never a tensor) raises.

Unpickling an allowlisted class never runs attacker-chosen code: dataclass
instances are rebuilt via object.__new__ + __dict__ update, enums via the
Enum class call, numpy arrays via `_reconstruct` — none of which execute
payload-controlled callables. The service still binds loopback by default;
this is defense in depth for the machine-room DCN deployments the twirp
layout targets.
"""

from __future__ import annotations

import io
import pickle

# numpy reconstruction helpers are data-only: they allocate an array and
# fill it from bytes. (numpy moved multiarray under _core in numpy 2.)
_NUMPY_ALLOWED = {
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy._core.numeric", "_frombuffer"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
}

_BUILTIN_ALLOWED = {
    ("builtins", "bytearray"),
    ("builtins", "bytes"),
    ("builtins", "complex"),
    ("builtins", "frozenset"),
    ("builtins", "range"),
    ("builtins", "set"),
    ("collections", "OrderedDict"),
    ("collections", "defaultdict"),
    ("collections", "Counter"),
}


# this package's own name, with the dot kept in the prefix test below: a
# bare prefix would let through any package whose name starts the same way
_PACKAGE = "ziren_tpu_torch"


class WireError(pickle.UnpicklingError):
    pass


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        key = (module, name)
        if key in _NUMPY_ALLOWED or key in _BUILTIN_ALLOWED:
            return super().find_class(module, name)
        if module == _PACKAGE or module.startswith(_PACKAGE + "."):
            # a dotted name walks attributes (protocol 4, which the payload
            # picks itself): "subprocess.Popen" or "torch.Tensor" would be
            # reached through any module of the package that imports them
            if "." in name:
                raise WireError(f"dotted global {module}.{name} refused")
            obj = super().find_class(module, name)
            # classes only: a module-level *function* reached via the
            # REDUCE opcode would be called with attacker-chosen args
            if not isinstance(obj, type):
                raise WireError(f"non-class global {module}.{name} refused")
            # and only classes the package defines itself, not the ones a
            # module of it merely imported (`Path`, `Popen`, `Tensor`)
            home = getattr(obj, "__module__", None) or ""
            if home == _PACKAGE or home.startswith(_PACKAGE + "."):
                return obj
            raise WireError(f"global {module}.{name} is defined in {home!r}, "
                            "not in this package: refused")
        raise WireError(f"global {module}.{name} is not allowlisted")


def dumps(obj) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def loads(data: bytes):
    return _RestrictedUnpickler(io.BytesIO(data)).load()
