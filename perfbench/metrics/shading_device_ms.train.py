"""Device milliseconds a step spends in the split-sum shading
(`render.shading`: specular_color_surfel, full_color_volume) and its
backward: the program's `shading` span and its `shading.bwd` twin."""


def read(t):
    if not t.has_span("shading"):
        return None
    return 1e3 * (t.span_device_s("shading") + t.span_device_s("shading.bwd")) / t.units
