"""Device milliseconds a view spends in the mesh tracer (`ops.mesh_tracer.trace`:
the pre-cull and the plain ray-triangle walk of the mesh visibility)."""
SPANS = [("materialrefgs_torch.ops.mesh_tracer", "trace", "mesh_tracer.trace")]


def read(t):
    if not t.has_span("mesh_tracer.trace"):
        return None
    return 1e3 * t.span_device_s("mesh_tracer.trace") / t.units
