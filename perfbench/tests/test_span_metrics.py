"""The readers of the program's own spans and counters: each returns a number
on a small CPU trace of the spans it reads and None on a trace without them
(what a program without the spans gives); on a trace with device kernels
each adds the kernels launched inside its spans, forward and backward."""
import pytest
import torch

from perfbench.core import trace as tracemod
from perfbench.core.manifest import load_metric

READERS = {
    "warp_bwd_device_ms.train": ("warp.nearest_render.bwd", "warp.calc_warp_loss.bwd"),
    "envlight_device_ms.train": ("envlight.mips", "envlight.mips.bwd"),
    "shading_device_ms.train": ("shading", "shading.bwd"),
    "loss_device_ms.train": ("losses", "losses.bwd"),
    "optimizer_device_ms.train": ("update.adam",),
    "rasterize_device_ms.train": ("rasterize", "rasterize.bwd"),
    "rasterize_device_ms.serve": ("rasterize",),
    "render_redos.train": ("trainer.pick", "trainer.redo", "trainer.redo"),
}


def _cpu_trace(names):
    """A torch.profiler CPU trace of the window holding one small op inside
    each named span."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(tracemod.WINDOW):
            for n in names:
                with torch.profiler.record_function(n):
                    torch.ones(8).sum()
    return tracemod.TraceView(prof, 2, {}, None)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_a_cpu_trace_and_nothing_without_its_spans(metric):
    reader = load_metric(metric)
    value = reader.read(_cpu_trace(READERS[metric]))
    assert isinstance(value, float)
    assert value == (1.0 if metric == "render_redos.train" else 0.0)  # two redos over two steps; no device
    assert reader.read(_cpu_trace(["aten::other", "Trainer.train"])) is None


class _Event:
    """The part of a kineto event that TraceView reads."""

    def __init__(self, name, start, end, device=False, thread=1, corr=0, linked=0):
        self.n, self.s, self.e, self.dev, self.th, self.corr, self.linked = name, start, end, device, thread, corr, linked

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.dev else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return False

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def start_thread_id(self):
        return self.th

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("R", (), {"events": lambda _: events})()})()


def test_readers_add_the_kernels_of_their_spans_forward_and_backward():
    """A forward span on the main thread and its twin on autograd's thread,
    each launching one kernel (1 ms and 3 ms), beside a kernel launched
    outside both: a reader counts the two and not the third, per step."""
    ev = [_Event(tracemod.WINDOW, 0, 100_000_000)]
    launches = [("rasterize", 1, 10), ("rasterize.bwd", 2, 20), ("update.backward", 1, 30)]
    t = 1_000_000
    for name, thread, corr in launches:
        ev.append(_Event(name, t, t + 2_000_000, thread=thread))
        ev.append(_Event("aten::op", t + 500_000, t + 600_000, thread=thread, corr=corr))
        t += 10_000_000
    ev += [_Event("k1", 40_000_000, 41_000_000, device=True, linked=10),
           _Event("k2", 50_000_000, 53_000_000, device=True, linked=20),
           _Event("k3", 60_000_000, 67_000_000, device=True, linked=30)]
    view = tracemod.TraceView(_Prof(ev), 2, {}, None)
    assert load_metric("rasterize_device_ms.train").read(view) == pytest.approx(2.0)  # (1 + 3) ms over 2 steps
    assert load_metric("rasterize_device_ms.serve").read(view) == pytest.approx(0.5)
