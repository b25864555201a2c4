"""Spans the harness records around the port's functions, in the traced run
only. `Spans.install(targets)` wraps each "module:Qualified.name" so that
every call adds (name, start, end) in time.time_ns(), the clock of
torch.profiler's events; `remove()` puts the originals back. A target that
no longer exists in the port is skipped and named in `missing`, and the
metrics that read its span then read nothing.

StarkMachine.prove is wrapped so that it also gets a `stats=` dict when its
caller passes none (the SDK's prove does not), and each call's dict is kept
in `stats`."""

from __future__ import annotations

import functools
import importlib
import threading
import time

STATS_TARGET = "ziren_tpu_torch.stark.machine:StarkMachine.prove"


def _resolve(target: str):
    """(owner object, attribute name, current value) of "module:A.b"."""
    mod_name, qual = target.split(":")
    owner = importlib.import_module(mod_name)
    parts = qual.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1], getattr(owner, parts[-1])


class Spans:
    def __init__(self):
        self.events: list = []  # (name, start_ns, end_ns)
        self.stats: list = []  # StarkMachine.prove's stats=, one dict a call
        self.missing: list = []
        self._undo: list = []
        self._lock = threading.Lock()

    def add(self, name: str, t0: int, t1: int) -> None:
        with self._lock:
            self.events.append((name, t0, t1))

    def of(self, name: str) -> list:
        with self._lock:
            return [(t0, t1) for n, t0, t1 in self.events if n == name]

    def seconds(self, name: str) -> float:
        return sum(t1 - t0 for t0, t1 in self.of(name)) / 1e9

    def _wrapper(self, name: str, target: str, fn):
        spans = self
        if target == STATS_TARGET:
            @functools.wraps(fn)
            def timed(*args, **kw):
                if kw.get("stats") is None:
                    kw["stats"] = {}
                t0 = time.time_ns()
                try:
                    return fn(*args, **kw)
                finally:
                    spans.add(name, t0, time.time_ns())
                    with spans._lock:
                        spans.stats.append(kw["stats"])
            return timed

        @functools.wraps(fn)
        def timed(*args, **kw):
            t0 = time.time_ns()
            try:
                return fn(*args, **kw)
            finally:
                spans.add(name, t0, time.time_ns())
        return timed

    def install(self, targets) -> None:
        """targets: [(span name, "module:Qualified.name")]; each once."""
        seen = set()
        for name, target in targets:
            if target in seen:
                continue
            seen.add(target)
            try:
                owner, attr, fn = _resolve(target)
            except (ImportError, AttributeError):
                self.missing.append(target)
                continue
            raw = owner.__dict__.get(attr, fn)  # a staticmethod stays one
            wrapped = self._wrapper(name, target, fn)
            setattr(owner, attr, staticmethod(wrapped) if isinstance(raw, staticmethod)
                    else wrapped)
            self._undo.append((owner, attr, raw))

    def remove(self) -> None:
        while self._undo:
            owner, attr, raw = self._undo.pop()
            setattr(owner, attr, raw)
