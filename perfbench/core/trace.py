"""Spans around the program's layers, set up at run time, and the reading of
a torch.profiler trace of the measured window.

A per-layer metric's file names the entry functions it reads
(`SPANS`: (module, attribute, span name[, predicate on the call's keyword
arguments])). In a traced run only, `install` replaces each such function,
wherever a module of the program holds it, by a wrapper that opens a
`torch.profiler.record_function` span of that name; `uninstall` puts the
originals back. Nothing in the program is edited. A span's device time is
the time of the kernels launched inside it, as the profiler attributes them;
a backward runs on autograd's own thread, outside any forward span, and is
read from the profiler's autograd node events by the Function's name.
"""
from __future__ import annotations

import bisect
import functools
import importlib
import re
import sys

import torch

WINDOW = "perfbench.window"
# A traced run measures a window of at most this many seconds: the profiler's
# stop and the reading of its events grow with the events, and a window of
# the plain mesh tracer's small kernels holds millions of them.
TRACE_WINDOW_S = 12.0


class Spans:
    def __init__(self):
        self._undo = []

    def install(self, spans: list):
        """Wrap every (module, attribute, name[, predicate]) once; methods are
        given as "Class.method"."""
        seen = set()
        for spec in spans:
            mod_name, attr, name = spec[:3]
            pred = spec[3] if len(spec) > 3 else None
            key = (mod_name, attr, name)
            if key in seen:
                continue
            seen.add(key)
            mod = importlib.import_module(mod_name)
            owner, leaf = mod, attr
            if "." in attr:
                cls_name, leaf = attr.split(".", 1)
                owner = getattr(mod, cls_name)
            orig = getattr(owner, leaf)
            wrapped = _wrap(orig, name, pred)
            # The attribute and every module of the program that imported
            # the same function by name.
            holders = [(owner, leaf)]
            if owner is mod:
                root = mod_name.split(".")[0]
                for m_name, m in list(sys.modules.items()):
                    if m is None or m is mod or m_name.split(".")[0] != root:
                        continue
                    for k, v in list(vars(m).items()):
                        if v is orig:
                            holders.append((m, k))
            for h, k in holders:
                setattr(h, k, wrapped)
                self._undo.append((h, k, orig))

    def uninstall(self):
        for h, k, orig in reversed(self._undo):
            setattr(h, k, orig)
        self._undo.clear()


def _wrap(fn, name, pred):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if pred is not None and not pred(kwargs):
            return fn(*args, **kwargs)
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceView:
    """What the metric readers read: the traced window's device events and
    host events (nanoseconds on the profiler's clock, read from the raw
    kineto events: building the profiler's FunctionEvent tree takes minutes
    for a window of the plain mesh tracer's small kernels), the number of
    steps or views the window completed, the benchmark's counters and the
    work counts.

    A kernel belongs to the host event that launched it (the kernel's linked
    correlation id); a span's device time is the time of the kernels whose
    launching event started inside the span, on the span's thread."""

    def __init__(self, prof, units: int, counts: dict, cost: dict | None):
        self.units = max(int(units), 1)
        self.counts = counts
        self.cost = cost or {}
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        kern, host = [], []
        for e in prof.profiler.kineto_results.events():
            dt = e.device_type()
            if dt == cuda:
                if not e.is_user_annotation():
                    kern.append((e.name(), e.start_ns(), e.end_ns(), e.linked_correlation_id()))
            elif dt == cpu:
                # A frontend op (linked id 0) is what a kernel's linked
                # correlation id names; runtime events carry their own ids.
                front = e.linked_correlation_id() == 0
                host.append((e.name(), e.start_ns(), e.end_ns(), e.start_thread_id(),
                             e.correlation_id() if front else 0))
        win = [h for h in host if h[0] == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no window span")
        _, self.t0, self.t1, self.thread, _ = win[0]
        self.window_s = (self.t1 - self.t0) / 1e9
        self.device = [(n, s, e, c) for n, s, e, c in kern if self.t0 <= s < self.t1]
        self.host = [h for h in host if self.t0 <= h[1] < self.t1]
        self._launch = {c: (th, s) for _, s, _, th, c in self.host if c}
        self._by_name: dict = {}
        for h in self.host:
            self._by_name.setdefault(h[0], []).append(h)

    # -- device --------------------------------------------------------------
    def busy_s(self) -> float:
        return sum(e - s for s, e in _merge([[s, e] for _, s, e, _ in self.device])) / 1e9

    def kernel_s(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(e - s for n, s, e, _ in self.device if rx.search(n)) / 1e9

    def top_device_ops(self, k: int = 10) -> list:
        tot = {}
        for n, s, e, _ in self.device:
            tot[n] = tot.get(n, 0.0) + (e - s) / 1e9
        return [[n, v] for n, v in sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The window's idle device time by the innermost host event of the
        main thread running at each gap's middle, largest first."""
        merged = _merge([[s, e] for _, s, e, _ in self.device])
        gaps, prev = [], self.t0
        for s, e in merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        evs = sorted((h for h in self.host if h[3] == self.thread), key=lambda h: h[1])
        starts = [h[1] for h in evs]
        tot = {}
        for s, e in gaps:
            mid = (s + e) / 2
            # Host events nest, so the innermost one running at `mid` is the
            # latest-starting one that has not ended.
            i, name = bisect.bisect_right(starts, mid) - 1, "(no host event)"
            for j in range(i, max(i - 200, -1), -1):
                if evs[j][2] >= mid:
                    name = evs[j][0]
                    break
            tot[name] = tot.get(name, 0.0) + (e - s) / 1e9
        return [[n, v] for n, v in sorted(tot.items(), key=lambda x: -x[1])[:k]]

    # -- spans ---------------------------------------------------------------
    def has_span(self, name: str) -> bool:
        return bool(self._by_name.get(name))

    def _intervals(self, match) -> dict:
        """Merged intervals per thread of the host events whose name matches."""
        per = {}
        for n, evs in self._by_name.items():
            if match(n):
                for _, s, e, th, _ in evs:
                    per.setdefault(th, []).append([s, e])
        return {th: _merge(iv) for th, iv in per.items()}

    def _device_in(self, intervals: dict) -> float:
        starts = {th: [s for s, _ in iv] for th, iv in intervals.items()}
        total = 0
        for _, s, e, corr in self.device:
            th, t = self._launch.get(corr, (None, None))
            iv = intervals.get(th)
            if iv:
                i = bisect.bisect_right(starts[th], t) - 1
                if i >= 0 and t <= iv[i][1]:
                    total += e - s
        return total / 1e9

    def span_host_s(self, name: str) -> float:
        return sum(e - s for iv in self._intervals(lambda n: n == name).values() for s, e in iv) / 1e9

    def span_device_s(self, name: str) -> float:
        """Device time of the kernels launched inside the spans `name`."""
        return self._device_in(self._intervals(lambda n: n == name))

    def backward_device_s(self, function_name: str) -> float:
        """Device time of the kernels launched by the autograd node of a
        torch.autograd.Function (its backward), e.g. "_TraceCoreBackward"."""
        return self._device_in(self._intervals(
            lambda n: n.startswith("autograd::engine::evaluate_function:") and function_name in n))
