"""The device's timeline over the traced window, from torch.profiler (CUPTI):
every operation that ran on the card, its busy seconds (the union of their
intervals, so that overlapping streams count once), the seconds by kernel
name, and the idle gaps labelled by the harness span the host was in.

torch.profiler's events carry wall-clock nanoseconds (time.time_ns()'s
clock), so the spans of spans.py fall on the same axis."""

from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field


def kernel_base(name: str) -> str:
    """A kernel's function name without its signature, templates or
    namespaces: "void ns::foo<int>(long*)", "(anonymous namespace)::foo(long*)",
    "_Z3fooPl" and "_ZN12_GLOBAL__N_13fooEPl" all give "foo"."""
    if name.startswith("_Z"):
        rest, last = name[2:], None
        if rest.startswith("N"):
            rest = rest[1:]
        while True:
            m = re.match(r"\d+", rest)
            if not m:
                break
            k = int(m.group())
            last, rest = rest[m.end(): m.end() + k], rest[m.end() + k:]
        return last or name
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    head = re.sub(r"<.*>", "", head).strip()
    return head.split()[-1].split("::")[-1] if head else name


def union_seconds(intervals, lo: int, hi: int) -> float:
    """Seconds covered by [start_ns, end_ns) intervals inside [lo, hi)."""
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e9


def gaps(intervals, lo: int, hi: int) -> list:
    """The idle [start_ns, end_ns) stretches of [lo, hi) between intervals."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


@dataclass
class DeviceTrace:
    events: list = field(default_factory=list)  # (name, start_ns, end_ns), device side
    t0: int = 0
    t1: int = 0
    _prof: object = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0 = time.time_ns()

    def stop(self) -> None:
        from torch.autograd import DeviceType

        self.t1 = time.time_ns()
        self._prof.__exit__(None, None, None)
        results = getattr(self._prof.profiler, "kineto_results", None)
        # the raw events: key_averages() takes minutes over some 100,000 kernels
        for e in results.events() if results is not None else ():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns()
                self.events.append((e.name(), s, s + e.duration_ns()))
        self._prof = None

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return union_seconds([(s, e) for _n, s, e in self.events], self.t0, self.t1)

    def seconds_by_kernel(self) -> dict:
        out: dict = {}
        for name, s, e in self.events:
            out[name] = out.get(name, 0.0) + (e - s) / 1e9
        return out

    def idle_by_label(self, pieces: list) -> dict:
        """Idle seconds of the window by what the host was doing: each gap
        split over the labelled pieces [(start_ns, end_ns, label)] it
        overlaps, a part outside every piece under "between requests"."""
        out: dict = {}

        def add(key, ns):
            if ns > 0:
                out[key] = out.get(key, 0.0) + ns / 1e9
        pieces = sorted(pieces)
        starts = [a for a, _b, _l in pieces]
        for s, e in gaps([(s, e) for _n, s, e in self.events], self.t0, self.t1):
            covered = 0
            for a, b, label in pieces[max(0, bisect.bisect_right(starts, s) - 1):]:
                if a >= e:
                    break
                part = min(b, e) - max(a, s)
                add(label, part)
                covered += max(0, part)
            add("between requests", (e - s) - covered)
        return out


def seconds_of(trace: DeviceTrace, names) -> float:
    """Device seconds of the kernels whose function name is in `names`."""
    return sum(t for name, t in trace.seconds_by_kernel().items() if kernel_base(name) in names)


def top(d: dict, k: int = 10) -> list:
    return [[name, v] for name, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]
