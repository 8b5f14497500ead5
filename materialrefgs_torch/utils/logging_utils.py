"""Observability: TensorBoard scalars and images, the psnr.json history
(the JAX package's utils/logging_utils.py; reference train_refnerf.py
prepare_output_and_logger:1644, training_report:1676, save_psnr:1759), and
the spans and counters that name each phase of a train step and a served
view in a torch.profiler trace.

`span(name)` (a context manager) and `spanned(name)` (a decorator) record a
`torch.profiler.record_function` interval of that name; `count(name)`
records one zero-length event, read in a trace as a count. All three do
nothing but test `torch.autograd._profiler_enabled()` unless a torch
profiler is recording, so any profiler an operator or a benchmark opens
around `Trainer.train` or `evaluate.render_set` shows them, on the clock it
gives the device's kernels.

A backward runs on autograd's own thread, outside every forward span.
`backward_spans(loss)`, called before the backward of `loss`, gives it the
same names: each autograd node created inside a span (found by its sequence
number, which a span notes at its entry and exit) runs inside a
`<name>.bwd` interval of every span that enclosed its creation, nested as
the forward spans were. The hooks it registers return nothing, so no
gradient changes; without a profiler it registers none.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import json
import os
import threading

import torch
from torch.autograd.profiler import record_function


class TrainLogger:
    """Writes under `log_dir`: psnr.json (the test PSNR history, continued
    across resumes) and, when torch.utils.tensorboard imports (it needs the
    tensorboard package), TensorBoard scalars and images."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        try:
            import importlib.util
            import sys
            import types

            # TensorBoard's event writer needs no TensorFlow: the tensorboard
            # package's "notf" marker makes it use its own stub instead of
            # importing TensorFlow where one is installed (seconds per run).
            if importlib.util.find_spec("tensorboard") and "tensorboard.compat.notf" not in sys.modules:
                sys.modules["tensorboard.compat.notf"] = types.ModuleType("tensorboard.compat.notf")
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(log_dir)
        except Exception:  # noqa: BLE001 - any import or set-up failure means no TensorBoard
            self.tb = None
        # A resumed run continues the history (reference save_psnr re-reads
        # psnr.json, train_refnerf.py:1759-1770).
        self.psnr_history: list[dict] = []
        p = os.path.join(log_dir, "psnr.json")
        if os.path.exists(p):
            try:
                with open(p) as f:
                    old = json.load(f)
                if isinstance(old, list):
                    self.psnr_history = old
            except (OSError, ValueError):
                pass

    def scalars(self, iteration: int, metrics: dict, prefix: str = "train"):
        if self.tb is None:
            return
        for k, v in metrics.items():
            try:
                self.tb.add_scalar(f"{prefix}/{k}", float(v), iteration)
            except (TypeError, ValueError):
                pass

    def image(self, iteration: int, name: str, img):
        if self.tb is None:
            return
        import numpy as np

        arr = np.clip(np.asarray(img), 0, 1)
        self.tb.add_image(name, arr.transpose(2, 0, 1), iteration)

    def test_psnr(self, iteration: int, psnr: float):
        """Append to psnr.json (train_refnerf.py:1759-1770)."""
        self.psnr_history.append({"iteration": iteration, "psnr": psnr})
        with open(os.path.join(self.log_dir, "psnr.json"), "w") as f:
            json.dump(self.psnr_history, f)
        if self.tb is not None:
            self.tb.add_scalar("test/psnr", psnr, iteration)

    def close(self):
        if self.tb is not None:
            self.tb.close()


# --------------------------------------------------- spans and counters ----
class _Thread(threading.local):
    """Per thread: the open forward spans, the autograd sequence ranges of
    the closed ones not yet handed to a backward, and the backward intervals
    entered by a node's pre-hook until its post-hook."""

    def __init__(self):
        self.open: list = []
        self.ranges: list = []  # (first seq, end seq, depth, name)
        self.bwd: list = []


_THREAD = _Thread()
# A forward that never runs a backward (a served view) keeps at most this many
# ranges; only the newest can name a node of a later backward.
_MAX_RANGES = 4096
_NULL = contextlib.nullcontext()
_next_seq = torch._C._autograd._get_sequence_nr


class _Span:
    __slots__ = ("name", "rf", "first")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = record_function(self.name)
        self.rf.__enter__()
        self.first = _next_seq()
        _THREAD.open.append(self)
        return self

    def __exit__(self, *exc):
        t = _THREAD
        t.open.pop()
        end = _next_seq()
        if end > self.first:  # the span created autograd nodes
            t.ranges.append((self.first, end, len(t.open), self.name))
            if len(t.ranges) > _MAX_RANGES:
                del t.ranges[: _MAX_RANGES // 2]
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A profiler interval named `name` around the block, or nothing when no
    profiler records."""
    return _Span(name) if torch.autograd._profiler_enabled() else _NULL


def spanned(name: str):
    """Decorator: every call of the function inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not torch.autograd._profiler_enabled():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str) -> None:
    """One zero-length profiler event named `name` (a redo, a refit)."""
    if torch.autograd._profiler_enabled():
        with record_function(name):
            pass


def _node_hooks(chain: tuple):
    """The (pre-hook, post-hook) pair that runs a node inside the `.bwd`
    interval of each span of `chain`, outermost first."""
    names = tuple(f"{n}.bwd" for n in chain)

    def pre(grad_outputs):
        rfs = [record_function(n) for n in names]
        for rf in rfs:
            rf.__enter__()
        _THREAD.bwd.append(rfs)

    def post(grad_inputs, grad_outputs):
        for rf in reversed(_THREAD.bwd.pop()):
            rf.__exit__(None, None, None)

    return pre, post


def _hook_node(node, hooks) -> None:
    node.register_prehook(hooks[0])
    node.register_hook(hooks[1])


def backward_spans(*roots: torch.Tensor) -> None:
    """Before the backward of `roots`: hook every node of their graph that a
    span of this thread created, so that it runs inside its spans' `.bwd`
    intervals. Hands this thread's recorded ranges to that backward. Does
    nothing unless a profiler records."""
    t = _THREAD
    ranges, t.ranges = t.ranges, []
    if not torch.autograd._profiler_enabled():
        return
    # The spans still open (the step's own) enclose every node made so far.
    end = _next_seq()
    ranges += [(s.first, end, depth, s.name) for depth, s in enumerate(t.open) if end > s.first]
    if not ranges:
        return
    # Spans nest, so the sequence numbers split into segments, each created
    # inside one chain of spans.
    bounds = sorted({b for lo, hi, _, _ in ranges for b in (lo, hi)})
    by_depth = sorted(ranges, key=lambda r: r[2])
    chains = [tuple(name for lo, hi, _, name in by_depth if lo <= b < hi) for b in bounds[:-1]]
    hooks: dict = {}
    seen = set()
    stack = [r.grad_fn for r in roots if r.grad_fn is not None]
    while stack:
        node = stack.pop()
        if node in seen:
            continue
        seen.add(node)
        i = bisect.bisect_right(bounds, node._sequence_nr()) - 1
        if 0 <= i < len(chains) and chains[i]:
            if chains[i] not in hooks:
                hooks[chains[i]] = _node_hooks(chains[i])
            _hook_node(node, hooks[chains[i]])
        stack.extend(n for n, _ in node.next_functions if n is not None)
