"""Declarative column layouts shared by trace generation and constraint eval.

A `Layout` names each column (or word / slice of columns) once; trace gen
writes numpy columns by name, eval reads folder values by name. This replaces
the reference's `#[derive(AlignedBorrow)]` column structs
(reference: crates/derive/src/lib.rs:33)."""

from __future__ import annotations

import numpy as np


class Layout:
    def __init__(self):
        self._slices: dict[str, slice] = {}
        self._n = 0

    def add(self, name: str, n: int = 1) -> "Layout":
        self._slices[name] = slice(self._n, self._n + n)
        self._n += n
        return self

    def word(self, name: str) -> "Layout":
        return self.add(name, 4)

    @property
    def width(self) -> int:
        return self._n

    def __contains__(self, name):
        return name in self._slices

    def slc(self, name: str) -> slice:
        return self._slices[name]

    def idx(self, name: str) -> int:
        s = self._slices[name]
        assert s.stop - s.start == 1, f"{name} is not a single column"
        return s.start

    # -- trace-side --------------------------------------------------------
    class Writer:
        def __init__(self, layout: "Layout", n_rows: int):
            self.layout = layout
            self.mat = np.zeros((n_rows, layout.width), dtype=np.uint32)

        def set(self, name: str, value):
            if self.mat.shape[0] == 0:
                return
            s = self.layout.slc(name)
            w = s.stop - s.start
            v = np.asarray(value)
            if w == 1:
                self.mat[:, s.start] = v.astype(np.uint32)
            else:
                self.mat[:, s] = v.astype(np.uint32)

        def set_word(self, name: str, u32_values):
            """Byte-decompose uint32 array into the 4 word columns."""
            if self.mat.shape[0] == 0:
                return
            v = np.asarray(u32_values, dtype=np.uint64)
            s = self.layout.slc(name)
            for i in range(4):
                self.mat[:, s.start + i] = ((v >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(
                    np.uint32
                )

    def writer(self, n_rows: int) -> "Layout.Writer":
        return Layout.Writer(self, n_rows)

    # -- eval-side ---------------------------------------------------------
    class View:
        """Named access over a folder's column list (local or next)."""

        def __init__(self, layout: "Layout", cols: list):
            self.layout = layout
            self.cols = cols

        def __getitem__(self, name: str):
            s = self.layout.slc(name)
            if s.stop - s.start == 1:
                return self.cols[s.start]
            return self.cols[s]

        def word(self, name: str) -> list:
            s = self.layout.slc(name)
            assert s.stop - s.start == 4
            return self.cols[s]

    def view(self, cols: list) -> "Layout.View":
        return Layout.View(self, cols)


# -- fixed trace heights (shape system) -------------------------------------
# When a target height is set (stark/shape.py fix_shape), every trace-height
# computation in this process pads to it instead of the next power of two.
# Per-chip padding logic in generate_trace (writes to mat[n_real:]) then
# covers the extended padding region unchanged — chips that need non-zero
# padding rows (Global's dummy curve point, keccak's dummy permutation
# chain, ...) produce them at ANY fixed height through the same code path.
# (reference: crates/core/machine/src/shape/mod.rs fix_shape)

import threading

_FIXED_HEIGHT = threading.local()  # per-thread: concurrent shard trace gen


class fixed_height:
    """Context manager: force trace heights to `target` (a power of two).
    Thread-local, so shard workers can generate under different targets
    concurrently."""

    def __init__(self, target):
        self.target = target

    def __enter__(self):
        self.prev = getattr(_FIXED_HEIGHT, "v", None)
        _FIXED_HEIGHT.v = self.target
        return self

    def __exit__(self, *exc):
        _FIXED_HEIGHT.v = self.prev
        return False


def trace_height(n_real: int, min_height: int = 4) -> int:
    """Padded height for a trace with n_real real rows."""
    n = max(int(n_real), 1)
    target = max(min_height, 1 << (n - 1).bit_length())
    fh = getattr(_FIXED_HEIGHT, "v", None)
    if fh is not None:
        assert target <= fh, f"trace needs {target} rows > fixed shape {fh}"
        target = fh
    return target


def pad_to_pow2(mat: np.ndarray, min_height: int = 4) -> np.ndarray:
    target = trace_height(mat.shape[0], min_height)
    if mat.shape[0] == target:
        return mat
    out = np.zeros((target, mat.shape[1]), dtype=np.uint32)
    out[: mat.shape[0]] = mat
    return out


def pack_word(word_cols: list):
    """Folder-side: word columns -> packed field value sum(b_i * 256^i)."""
    acc = word_cols[0]
    mult = 1
    for i in range(1, 4):
        mult *= 256
        acc = acc + word_cols[i] * mult
    return acc


def word_decompose_np(v) -> np.ndarray:
    """(n,) uint32 -> (n, 4) bytes."""
    v = np.asarray(v, dtype=np.uint64)
    return np.stack([((v >> np.uint64(8 * i)) & np.uint64(0xFF)) for i in range(4)], axis=1).astype(
        np.uint32
    )
