"""The traced run's reduction: torch.profiler's kineto events -> device
busy time and device time by operation (a pass that traces the card
alone), and device time by harness span and the idle gaps by what the
host was doing (a second pass that traces the host too, whose own cost
would inflate the first pass's idle time).

Spans are `torch.profiler.record_function` ranges that the benchmark
opens around calls into the program from its own files (`span`); a
device operation belongs to a span when the host call that launched it
(matched by correlation id) ran inside it.  An operation with no launch
record inherits the span of the operation before it on the stream."""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

WINDOW = "pb.window"
TOP = 10
NAME = 160      # a device operation's name is cut to this length


@contextlib.contextmanager
def span(name: str):
    with torch.profiler.record_function(name):
        yield


def wrapped(fn, name: str):
    """`fn` called inside the span `name`."""
    def call(*a, **kw):
        with span(name):
            return fn(*a, **kw)
    return call


def profiler(host: bool):
    """torch.profiler over the card's activity, and with `host` over every
    host operation too (which slows the host by some 15%: a decode step
    of ~1,500 eager operations)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host or not torch.cuda.is_available() \
        else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _device_events(prof, cuda, marks=()):
    """(start, end, name, correlation) of each device operation, without
    the device-side copies of host spans."""
    return [(e.start_ns(), e.end_ns(), e.name(), e.correlation_id())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()
            and e.name() not in marks]


def reduce_device(prof, window_s: float, device_type=None) -> dict:
    """A pass traced with `profiler(host=False)`: -> {"window_s" (the
    host's wall over the pass), "busy_s", "device_s" {op name: s},
    "device_ops" [[name, s]] (top 10)}."""
    cuda = device_type or torch.autograd.DeviceType.CUDA
    dev = _device_events(prof, cuda)
    by_op: dict[str, float] = defaultdict(float)
    for a, b, name, _ in dev:
        by_op[name[:NAME]] += (b - a) * 1e-9
    busy = _merge([(a, b) for a, b, _, _ in dev])
    return {"window_s": window_s,
            "busy_s": sum(b - a for a, b in busy) * 1e-9,
            "device_s": dict(by_op),
            "device_ops": [[n, s] for n, s in sorted(
                by_op.items(), key=lambda kv: -kv[1])[:TOP]]}


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Spans:
    """Host intervals of one span name, for point lookups."""

    def __init__(self):
        self.iv = []

    def add(self, a, b):
        self.iv.append((a, b))

    def freeze(self):
        self.iv.sort()
        self.starts = [a for a, _ in self.iv]

    def contains(self, t) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            a, b = self.iv[i]
            if b >= t:
                return True
            if i and self.iv[i - 1][1] < a:
                return False
            i -= 1
        return False


def reduce_spans(prof, device_type=None) -> dict:
    """A pass traced with `profiler(host=True)` inside the `pb.window`
    span: -> {"span_device_s" {span: device seconds of the operations
    launched inside it}, "idle_gaps" [[what the host was doing, s]] (top
    10, under the host tracing's own cost)}."""
    cuda = device_type or torch.autograd.DeviceType.CUDA
    evs = list(prof.profiler.kineto_results.events())
    win = [e for e in evs if e.name() == WINDOW and e.device_type() != cuda]
    if not win:
        raise RuntimeError("the trace has no window span")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    main = win[0].start_thread_id()
    launch, host = {}, []
    spans: dict[str, _Spans] = defaultdict(_Spans)
    marks = {e.name() for e in evs
             if e.device_type() != cuda and e.is_user_annotation()}
    for e in evs:
        if e.device_type() == cuda:
            continue
        if e.correlation_id():
            launch[e.correlation_id()] = e.start_ns()
        if e.start_thread_id() != main or e.end_ns() < w0 or e.start_ns() > w1:
            continue
        if e.is_user_annotation():
            if e.name() != WINDOW:
                spans[e.name()].add(e.start_ns(), e.end_ns())
                host.append((e.start_ns(), e.end_ns(), e.name(), True))
        elif not e.name().startswith(("cuda", "cu")):
            host.append((e.start_ns(), e.end_ns(), e.name(), False))
    for s in spans.values():
        s.freeze()
    dev = [(max(a, w0), min(b, w1), corr) for a, b, _, corr in
           sorted(_device_events(prof, cuda, marks)) if min(b, w1) > max(a, w0)]
    by_span: dict[str, float] = defaultdict(float)
    prev: tuple = ()
    for a, b, corr in dev:
        t = launch.get(corr)
        owners = (tuple(n for n, s in spans.items() if s.contains(t))
                  if t is not None else prev)
        for n in owners:
            by_span[n] += (b - a) * 1e-9
        prev = owners
    gaps, edge = [], w0
    for a, b in _merge([(a, b) for a, b, _ in dev]):
        if a > edge:
            gaps.append((edge, a))
        edge = b
    if w1 > edge:
        gaps.append((edge, w1))
    return {"span_device_s": dict(by_span),
            "idle_gaps": _label_gaps(gaps, host)}


def _label_gaps(gaps, host):
    """Total idle seconds by what the host was doing when each gap began:
    the innermost harness span and the innermost operation open on the
    host thread."""
    host.sort()
    totals: dict[str, float] = defaultdict(float)
    stack: list = []
    i = 0
    for g0, g1 in sorted(gaps):
        while i < len(host) and host[i][0] <= g0:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        live = [h for h in stack if h[1] >= g0]
        where = next((h[2] for h in reversed(live) if h[3]), "-")
        op = next((h[2] for h in reversed(live) if not h[3]), "python")
        totals[f"{where} | {op}"] += (g1 - g0) * 1e-9
    return [[n, s] for n, s in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:TOP]]
