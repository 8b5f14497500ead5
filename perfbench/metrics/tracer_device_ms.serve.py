"""Device milliseconds a served view spends in the splat tracer
(`ops.tracer.api.trace`: the cull, the ranges and the forward kernel)."""
SPANS = [("materialrefgs_torch.ops.tracer.api", "trace", "tracer.trace")]


def read(t):
    if not t.has_span("tracer.trace"):
        return None
    return 1e3 * t.span_device_s("tracer.trace") / t.units
