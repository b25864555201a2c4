"""The port's own spans (ziren_tpu_torch/trace.py) in a traced run, and
what they say of the device's timeline (devtrace.py), both in
time.time_ns():

- `window_spans(run)`: the spans of the window's requests, from a recorder
  that opens when a traced run of the harness asks these readers for their
  WRAPS, after set-up's warm request and just before its window, and closes
  when they are read; None where the port has no spans of its own;
- `program_seconds`: host seconds by span name, total and self;
- `Timeline`: on each thread, the innermost span open at any instant;
- `device_by_span`: device seconds by the innermost span the proving thread
  was in when each operation started on the card;
- `idle_by_span`: the card's idle seconds by the innermost span of the
  proving thread;
- `attributed`: the shares of device and idle seconds inside requests that
  fall under a span below `request`;
- `ops_under`: device operations started under a span of a given name;
- `fields(run)`: all of these, as `trace_report.py` prints them.

A span here is anything with the trace.Span fields: id, parent, request,
name, thread, t0_ns, t1_ns, attrs. The profiler's timeline that the harness
keeps holds each operation's device interval and not the host call that
launched it, so an operation is put down to the span open on the proving
thread when it started on the card: at the card's 93-99% idle share (PERF.md
section 5) the queue is near-empty and an operation starts some
microseconds after its launch. What is still queued when a span ends starts
under the next one; a count that must hold all of a stage's operations
counts under a span that waits for the card before it ends (`prove`, whose
`fetch` copies the results to the host).

The recorder, its opening at the WRAPS of a traced run and `last_run` stand
in for a `trace.collect()` around the window in harness.py, which this file
may not edit (PERF.md section 7).
"""

from __future__ import annotations

import bisect
import sys
from collections import Counter

OUTSIDE = "between requests"  # no span open: the label devtrace gives the same time

_collecting = None  # the open trace.collect()
_recorder = None  # what it records into
_window: tuple = (None, None)  # (the run, its spans), once read
last_run = None  # the last run whose spans a reader read


def reader_attr(name: str):
    """A span reader's module `__getattr__`. harness.run_cell asks each
    reader of a traced run for its WRAPS just before the window opens: the
    recorder opens then, and at no other time."""
    if name != "WRAPS":
        raise AttributeError(name)
    if _in_traced_run():
        _open()
    return []


def _in_traced_run() -> bool:
    from . import harness

    f = sys._getframe(1)
    while f is not None:
        if f.f_code is harness.run_cell.__code__:
            return bool(f.f_locals.get("trace"))
        f = f.f_back
    return False


def _open() -> None:
    global _collecting, _recorder
    if _recorder is not None:
        return
    try:
        from ziren_tpu_torch import trace
    except ImportError:  # a port without spans of its own
        return
    _collecting = trace.collect()
    _recorder = _collecting.__enter__()


def _close() -> None:
    global _collecting, _recorder
    if _collecting is not None:
        _collecting.__exit__(None, None, None)
    _collecting = _recorder = None


def window_spans(run):
    """The spans of the run's window (those inside its requests), or None.
    The first read takes them from the recorder and closes it."""
    global _window, last_run
    if not run.requests:
        return None
    if _window[0] is not run:
        if _recorder is None:
            return None
        lo = min(r.t0_ns for r in run.requests)
        hi = max(r.t1_ns for r in run.requests)
        spans = _recorder.take()
        _close()
        _window = (run, [s for s in spans if lo <= s.t0_ns and s.t1_ns <= hi])
    last_run = run
    return _window[1]


def label(s) -> str:
    """A span's label: its name, with the chip under trace generation."""
    if s is None:
        return OUTSIDE
    chip = s.attrs.get("chip") if s.name.startswith("tracegen") else None
    return f"{s.name}[{chip}]" if chip is not None else s.name


def program_seconds(spans, n_done: int) -> dict:
    """{name: {"total", "self"}} in seconds per completed request; a span's
    self time is its duration less the union of its children's on its own
    thread (work that it handed to a pool runs beside it, not inside it)."""
    if not n_done:
        return {}
    kids: dict = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append(s)
    total: dict = {}
    own: dict = {}
    for s in spans:
        dur = s.t1_ns - s.t0_ns
        inside = _union([(max(k.t0_ns, s.t0_ns), min(k.t1_ns, s.t1_ns))
                         for k in kids.get(s.id, ()) if k.thread == s.thread])
        total[s.name] = total.get(s.name, 0) + dur
        own[s.name] = own.get(s.name, 0) + dur - inside
    return {n: {"total": total[n] / 1e9 / n_done, "self": own[n] / 1e9 / n_done}
            for n in sorted(total, key=lambda n: -total[n])}


def _union(intervals) -> int:
    out, cur_s, cur_e = 0, None, None
    for a, b in sorted(iv for iv in intervals if iv[1] > iv[0]):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                out += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return out + (cur_e - cur_s if cur_e is not None else 0)


class Timeline:
    """The innermost span open at an instant, thread by thread: each
    thread's time cut where any of its spans starts or ends, each piece
    given the latest-started span still open (spans nest on one thread)."""

    def __init__(self, spans):
        self.by_id = {s.id: s for s in spans}
        threads: dict = {}
        for s in spans:
            threads.setdefault(s.thread, []).append(s)
        self.pieces = {t: self._pieces(ss) for t, ss in threads.items()}
        self._starts = {t: [a for a, _b, _s in p] for t, p in self.pieces.items()}
        roots = Counter(s.thread for s in spans if s.name == "request")
        # the thread that proves: the one that opened the requests
        self.main = roots.most_common(1)[0][0] if roots else None

    @staticmethod
    def _pieces(spans) -> list:
        cuts = sorted({t for s in spans for t in (s.t0_ns, s.t1_ns)})
        order = sorted(spans, key=lambda s: (s.t0_ns, s.id))
        out, stack, k = [], [], 0
        for a, b in zip(cuts, cuts[1:]):
            while k < len(order) and order[k].t0_ns <= a:
                stack.append(order[k])
                k += 1
            while stack and stack[-1].t1_ns <= a:
                stack.pop()
            inner = next((s for s in reversed(stack) if s.t1_ns > a), None)
            out.append((a, b, inner))
        return out

    def at(self, thread, t: int):
        """The innermost span open on `thread` at `t`, or None."""
        pieces = self.pieces.get(thread)
        if not pieces:
            return None
        i = bisect.bisect_right(self._starts[thread], t) - 1
        if i < 0:
            return None
        a, b, s = pieces[i]
        return s if a <= t < b else None

    def labelled_pieces(self) -> list:
        """[(start_ns, end_ns, label)] of the proving thread, for
        DeviceTrace.idle_by_label."""
        return [(a, b, label(s)) for a, b, s in self.pieces.get(self.main, [])]

    def under(self, s, name: str) -> bool:
        """Whether `s` is, or lies under, a span named `name`."""
        while s is not None:
            if s.name == name:
                return True
            s = self.by_id.get(s.parent)
        return False


def _started_under(dev, tl: Timeline) -> list:
    """The innermost span of the proving thread at each operation's start."""
    return [tl.at(tl.main, s) for _n, s, _e in dev.events]


def device_by_span(dev, tl: Timeline) -> dict:
    """Device seconds by the label of the span each operation started
    under."""
    out: dict = {}
    for (_n, s, e), sp in zip(dev.events, _started_under(dev, tl)):
        key = label(sp)
        out[key] = out.get(key, 0.0) + (e - s) / 1e9
    return out


def idle_by_span(dev, tl: Timeline) -> dict:
    """The card's idle seconds by the innermost span of the proving thread."""
    return dev.idle_by_label(tl.labelled_pieces())


def attributed(dev, tl: Timeline) -> dict:
    """{device_pct, idle_pct}: of the device seconds that started inside a
    request, and of the idle seconds inside a request, the shares under a
    span below `request` (a stage, not the request alone)."""
    dev_in = dev_below = 0.0
    for (_n, s, e), sp in zip(dev.events, _started_under(dev, tl)):
        if sp is None:
            continue
        dev_in += e - s
        if sp.name != "request":
            dev_below += e - s
    idle = idle_by_span(dev, tl)
    idle_in = sum(v for k, v in idle.items() if k != OUTSIDE)
    idle_below = idle_in - idle.get("request", 0.0)
    return {"device_pct": 100.0 * dev_below / dev_in if dev_in else None,
            "idle_pct": 100.0 * idle_below / idle_in if idle_in else None}


def ops_under(dev, tl: Timeline, name: str) -> int:
    """Device operations that started under a span named `name`."""
    hit: dict = {}
    n = 0
    for sp in _started_under(dev, tl):
        if sp is None:
            continue
        if sp.id not in hit:
            hit[sp.id] = tl.under(sp, name)
        n += hit[sp.id]
    return n


def fields(run) -> dict:
    """What the port's spans add to a traced run: seconds per request by
    span (`program_s`) and, with the device's timeline, the 15 largest
    device and idle totals by span and the shares put down to a stage."""
    spans = window_spans(run)
    if spans is None:
        return {}
    out = {"program_s": program_seconds(spans, len(run.done))}
    if run.device is not None and run.device.events and spans:
        from .devtrace import top

        tl = Timeline(spans)
        out["device_by_span"] = top(device_by_span(run.device, tl), 15)
        out["idle_by_span"] = top(idle_by_span(run.device, tl), 15)
        out["attributed"] = attributed(run.device, tl)
    return out
