"""Host seconds by chip in trace generation, copied from chip_smoke.py's
`_TraceGenClock` at commit 88d1ffc: it wraps each chip's
generate_dependencies and generate_trace on one machine's chips while it is
installed, and `remove` takes the wrappers off again."""

from __future__ import annotations

import threading
import time


class TraceGenClock:
    def __init__(self, machine):
        self.seconds: dict = {}
        self._lock = threading.Lock()
        self._airs = [c.air for c in machine.chips]
        for c in machine.chips:
            for fn in ("generate_dependencies", "generate_trace"):
                setattr(c.air, fn, self._timed(c.name, getattr(c.air, fn)))

    def _timed(self, name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                with self._lock:
                    self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
        return timed

    def take(self) -> dict:
        with self._lock:
            out, self.seconds = self.seconds, {}
        return out

    def remove(self) -> None:
        for air in self._airs:
            for fn in ("generate_dependencies", "generate_trace"):
                air.__dict__.pop(fn, None)
