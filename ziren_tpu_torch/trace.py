"""The port's spans: where a prove spends its host time, by stage.

    from ziren_tpu_torch import trace

    with trace.collect() as rec:
        client.prove(pk, stdin, shard_size=1 << 22)
    for s in rec.spans:
        print(s.name, s.attrs, (s.t1_ns - s.t0_ns) / 1e9)

`span(name, **attrs)` marks a stretch of work, as a context manager or, with
a name alone, as a decorator. Nothing is recorded unless a `collect()` is
open: then every span that ends is kept in memory by each open recorder.
Nothing is written anywhere.

Each span has an `id`, the `parent` span that was open when it began (in its
thread, or in the thread that handed it the work: pools carry the caller's
context over with `carried`), the `request` it belongs to
(the id of its root span: every span of one `ProverClient.prove` call
shares it), its `thread` (`threading.get_ident()`, whose low 32 bits are
the thread that kineto gives a CUDA runtime call), `t0_ns` and `t1_ns` in
`time.time_ns()` (the clock of torch.profiler's events) and its `attrs`.

While nothing records, `span()` checks one flag and returns a shared no-op
object whose entry and exit are C calls: no clock read, no lock, no Python
frame.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time

_on = False  # a recorder is open
_recorders: tuple = ()
_lock = threading.Lock()  # held to open or close a recorder, never by a span
_current: contextvars.ContextVar = contextvars.ContextVar("ziren_tpu_torch.span", default=None)
_ids = itertools.count(1)
_now = time.time_ns
_thread_id = threading.get_ident


class Span:
    """One recorded stretch of work (see the module's docstring)."""

    __slots__ = ("id", "parent", "request", "name", "thread", "t0_ns", "t1_ns", "attrs",
                 "_token")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        """Add attributes known only once the work has run."""
        self.attrs.update(attrs)

    def __enter__(self):
        up = _current.get()
        self.id = i = next(_ids)
        if up is None:
            self.parent, self.request = None, i
        else:
            self.parent, self.request = up.id, up.request
        self.thread = _thread_id()
        self._token = _current.set(self)
        self.t0_ns = _now()
        return self

    def __exit__(self, kind, _value, _tb):
        self.t1_ns = _now()
        _current.reset(self._token)
        if kind is not None:
            self.attrs["error"] = kind.__name__
        for rec in _recorders:
            rec.spans.append(self)  # list.append holds the GIL: no lock
        return False

    def __call__(self, fn):
        return _decorate(fn, self.name, self.attrs)

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, attrs={self.attrs})")


class _Idle:
    """What `span()` returns while nothing records. Entering gives the shared
    OFF, whose `set` does nothing; `__enter__` and `__exit__` are C callables
    (set below the class), so a `with` costs no Python frame. A named one
    (one per name, kept) decorates."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def set(self, **attrs) -> None:
        pass

    def __call__(self, fn):
        if self.name is None:
            raise TypeError("span(): as a decorator a span takes a name alone")
        return _decorate(fn, self.name, {})


OFF = _Idle(None)
_Idle.__enter__ = itertools.repeat(OFF).__next__  # () -> OFF
_Idle.__exit__ = type.__prepare__  # (*args) -> {}: falsy, so an exception passes on
_named: dict = {}  # name -> _Idle(name)


def _idle(name: str) -> _Idle:
    return _named.setdefault(name, _Idle(name))


def _decorate(fn, name: str, attrs: dict):
    if attrs:
        raise TypeError("span(): as a decorator a span takes a name alone")
    import functools

    @functools.wraps(fn)
    def spanned(*args, **kw):
        with span(name):
            return fn(*args, **kw)
    return spanned


def span(name: str, **attrs):
    """A span named `name`: a context manager (`with span("upload", bytes=n)
    as s: ...; s.set(more=...)`) or, given a name alone, a decorator. While
    no recorder is open it is a shared no-op."""
    if not _on:
        return OFF if attrs else _named.get(name) or _idle(name)
    return Span(name, attrs)


def current():
    """The innermost span open here, or the shared no-op while nothing
    records: `current().set(...)` adds to it from code it calls."""
    return _current.get() or OFF


def carried(fn):
    """`fn`, to hand to a pool: each call runs in a copy of the context
    here, so that a worker's spans lie under the span open at this call."""
    ctx = contextvars.copy_context()
    return lambda *args, **kw: ctx.copy().run(fn, *args, **kw)


class Recorder:
    """The spans that ended while it was open, in the order they ended."""

    def __init__(self):
        self.spans: list = []

    def take(self) -> list:
        """The spans recorded so far, which it then forgets."""
        out, self.spans = self.spans, []
        return out


class collect:
    """`with collect() as rec:` records every span that ends until the block
    exits, into the Recorder `rec`. Recorders may be open in several
    threads at once: each keeps every span."""

    def __enter__(self) -> Recorder:
        global _on, _recorders
        self.rec = Recorder()
        with _lock:
            _recorders = _recorders + (self.rec,)
            _on = True
        return self.rec

    def __exit__(self, *_exc) -> bool:
        global _on, _recorders
        with _lock:
            _recorders = tuple(r for r in _recorders if r is not self.rec)
            _on = bool(_recorders)
        return False


def seconds_by_chip(spans) -> dict:
    """Host seconds of trace generation by chip: the `tracegen.deps` and
    `tracegen.trace` spans that name one."""
    out: dict = {}
    for s in spans:
        chip = s.attrs.get("chip")
        if chip is not None and s.name in ("tracegen.deps", "tracegen.trace"):
            out[chip] = out.get(chip, 0.0) + (s.t1_ns - s.t0_ns) / 1e9
    return out
