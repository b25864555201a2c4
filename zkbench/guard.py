"""The import guard: a run that ends with jax, jaxlib, flax or the JAX package
`ziren_tpu` loaded prints no result. Names are compared by their top-level
part whole (`ziren_tpu_torch` is not `ziren_tpu`)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "ziren_tpu")


def forbidden(modules=None) -> list:
    """The forbidden top-level names among `modules` (sys.modules' keys by
    default), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))
