"""Spans and counters of the port, on torch.profiler's clock.

`span(name)` marks one layer's work, as a context manager (`with
span("serve.step"): ...`) or as a decorator (`@span("moe.apply")`);
`count(name, n)` adds to a counter; `h2d(nbytes)` and `d2h()` count the
host crossings of the serve path and open the `host.sync` span that holds
each (a read waits for the device; so does a copy from pageable host
memory past CUDA's small-copy size).  Everything records only while a torch
profiler is active on the calling thread: otherwise `span` returns a
shared no-op and `count` returns at once, so the program pays one flag
check a span and nothing else.  There is no other switch.

On, a span opens `torch.profiler.record_function(name)`, so the kineto
trace holds it on the device operations' clock (the timeline: device time
by span, idle gaps by the innermost span), and adds to in-memory
aggregates by name: the spans closed, their host wall time and their host
self time (wall less the direct children's wall, from a per-thread
stack).  `snapshot()` returns the aggregates and the counters; `reset()`
clears them.

A profiler sees only the thread that started it.  Work handed to another
thread (the spill worker) goes through `bind(fn)`, which runs `fn` on
that thread under the gate of the thread that bound it: its spans and
counts land in the aggregates, though not in the trace."""

from __future__ import annotations

import functools
import threading
import time

import torch

_profiling = torch._C._autograd._profiler_enabled
_lock = threading.Lock()
_local = threading.local()
_spans: dict[str, list] = {}      # name -> [n, wall_s, self_s]
_counts: dict[str, int] = {}
_idle: dict[str, "_Idle"] = {}
_bound = [0]        # calls running under `bind`, on any thread


def _on() -> bool:
    return _profiling() or (_bound[0] > 0
                            and getattr(_local, "bound", False))


class _Idle:
    """A span that records nothing.  As a decorator it wraps a function
    in `span(name)`, decided at each call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _on():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return spanned


class _Span(_Idle):
    __slots__ = ("rf", "t0", "child")

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.child = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child += wall
        with _lock:
            agg = _spans.setdefault(self.name, [0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += wall
            agg[2] += wall - self.child
        self.rf.__exit__(*exc)
        return False


def span(name: str) -> _Idle:
    """A span named `name`: a context manager, or a decorator."""
    if _on():
        return _Span(name)
    idle = _idle.get(name)
    if idle is None:
        idle = _idle.setdefault(name, _Idle(name))
    return idle


def count(name: str, n=1) -> None:
    """Add `n` to the counter `name`."""
    if _on():
        with _lock:
            _counts[name] = _counts.get(name, 0) + int(n)


def h2d(nbytes: int) -> _Idle:
    """One host array of `nbytes` bytes put on the serve path's device
    (`host.h2d`, `host.h2d_bytes`), copied inside the span it returns
    (`host.sync`)."""
    if _on():
        count("host.h2d")
        count("host.h2d_bytes", nbytes)
    return span("host.sync")


def d2h(n: int = 1) -> _Idle:
    """`n` device-to-host reads (`host.d2h`), made inside the span it
    returns (`host.sync`)."""
    count("host.d2h", n)
    return span("host.sync")


def bind(fn):
    """`fn`, to run on another thread under this thread's gate."""
    if not _on():
        return fn

    @functools.wraps(fn)
    def bound(*args, **kwargs):
        was = getattr(_local, "bound", False)
        _local.bound = True
        with _lock:
            _bound[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            with _lock:
                _bound[0] -= 1
            _local.bound = was
    return bound


def snapshot() -> dict:
    """{"spans": {name: {"n", "wall_s", "self_s"}}, "counts": {name: n}}
    since the last `reset()`."""
    with _lock:
        return {"spans": {k: {"n": n, "wall_s": w, "self_s": s}
                          for k, (n, w, s) in _spans.items()},
                "counts": dict(_counts)}


def reset() -> None:
    with _lock:
        _spans.clear()
        _counts.clear()


__all__ = ["span", "count", "h2d", "d2h", "bind", "snapshot", "reset"]
