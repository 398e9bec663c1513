"""Host spans and device traces of a run.

``Spans`` records the harness's own host spans (perf_counter) around the
calls it makes into each layer of the program, and the wrappers the
per-layer readers install on the program's objects; spans are kept by
phase, the measured window and the traced segment, and not at all outside
them.

``traced`` is a copy of ``chip_smoke.py``'s padded and retried profiler
session (``_trace``, ``TRACE_PAD_S``, ``TRACE_TRIES``): the tracer drops
device events it places outside a session's window, so the session idles
``TRACE_PAD_S`` before the first call and after the last has finished, and
a session that comes back with no device event is traced again, up to
``TRACE_TRIES`` sessions.  The session records CUDA activity only; host
spans are put on the trace's clock through the wall clock, which the
trace's ``baseTimeNanoseconds`` plus ``ts`` follow.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

TRACE_TRIES = 6
TRACE_PAD_S = 0.02
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Named host intervals (perf_counter seconds), kept by phase: the
    measured window (``"window"``) and the traced segment (``"trace"``);
    nothing is kept while ``phase`` is None."""

    def __init__(self):
        self.phase = None
        self.intervals = defaultdict(lambda: defaultdict(list))

    def add(self, name: str, t0: float, t1: float) -> None:
        if self.phase is not None:
            self.intervals[self.phase][name].append((t0, t1))

    def span(self, name: str):
        return _Span(self, name)

    def total(self, name: str, phase: str = "window") -> tuple[float, int]:
        """(seconds, count) of the spans of ``name`` in ``phase``."""
        iv = self.intervals[phase].get(name, [])
        return sum(b - a for a, b in iv), len(iv)


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.add(self.name, self.t0, time.perf_counter())
        return False


def wrap_method(spans: Spans, obj, attr: str, name: str,
                generator: bool = False):
    """Replace ``obj.attr`` (a bound method) by one that records a span of
    ``name`` around each call, or, for a generator, around each step of
    it; returns an undo function."""
    orig = getattr(obj, attr)

    if generator:
        def wrapped(*a, **kw):
            it = orig(*a, **kw)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    spans.add(name, t0, time.perf_counter())
                    return
                spans.add(name, t0, time.perf_counter())
                yield item
    else:
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                spans.add(name, t0, time.perf_counter())

    setattr(obj, attr, wrapped)
    return lambda: setattr(obj, attr, orig)


class Trace:
    """The device events of one traced segment, on the host's perf_counter
    clock (seconds): ``events`` [(name, t0, t1)], ``window`` (t0, t1)."""

    def __init__(self, events, window):
        self.events, self.window = events, window

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device events, clipped to the window."""
        lo, hi = self.window
        out = []
        for _, a, b in sorted(self.events, key=lambda e: e[1]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def by_name(self, substring: str) -> tuple[float, int]:
        """(summed seconds, launches) of the events whose name holds
        ``substring``."""
        sel = [b - a for n, a, b in self.events if substring in n]
        return sum(sel), len(sel)

    def top_ops(self, k: int = 10) -> list:
        tot = defaultdict(float)
        for n, a, b in self.events:
            tot[n[:120]] += b - a
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda r: -r[1])[:k]

    def idle_gaps(self, spans: Spans, k: int = 10) -> list:
        """The ``k`` longest idle gaps in the window, each named by the
        innermost host span of the ``trace`` phase open over at least half
        of it (the one whose intervals there are shortest: ``postprocess``
        inside ``frame``), else the one that covers most of it, ``host``
        where the harness had none open."""
        lo, hi = self.window
        gaps, t = [], lo
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            cover = {}
            for name, iv in spans.intervals["trace"].items():
                hits = [(x, y) for x, y in iv if y > a and x < b]
                if hits:
                    c = sum(min(b, y) - max(a, x) for x, y in hits)
                    cover[name] = (c, sum(y - x for x, y in hits) / len(hits))
            inner = [n for n, (c, _) in cover.items() if c >= 0.5 * (b - a)]
            name = (min(inner, key=lambda n: cover[n][1]) if inner
                    else max(cover, key=lambda n: cover[n][0], default="host"))
            out.append([name, b - a])
        return out


def traced(torch, fn, tries: int = TRACE_TRIES) -> Trace:
    """Run ``fn()`` (one traced segment) in a padded torch.profiler
    session of CUDA activity; trace it again, up to ``tries`` sessions,
    while the trace holds no device event.  ``fn`` must leave the device
    synchronised."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAD_S)
            # the trace's clock is the wall clock: pair it with perf_counter
            wall0, perf0 = time.time_ns(), time.perf_counter()
            fn()
            torch.cuda.synchronize()
            perf1 = time.perf_counter()
            time.sleep(TRACE_PAD_S)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
        shift = perf0 - wall0 / 1e9  # perf_counter minus wall, seconds
        events = []
        for e in trace.get("traceEvents", []):
            if e.get("cat") in DEVICE_CATS and "ts" in e:
                t0 = (base_us + float(e["ts"])) / 1e6 + shift
                events.append((e.get("name", ""), t0,
                               t0 + float(e.get("dur", 0.0)) / 1e6))
        if events:
            return Trace(events, (perf0, perf1))
    raise RuntimeError(f"no device event in {tries} traced sessions")
