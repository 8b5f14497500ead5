"""Device milliseconds a step spends in the warp's forward (`train.warp`):
the nearest view's geometry-only render and calc_warp_loss. Their backward
runs inside autograd's own nodes and is not counted here."""
SPANS = [
    ("materialrefgs_torch.render.renderers", "render_surfel", "warp.nearest_render",
     lambda kwargs: bool(kwargs.get("wo_render_img"))),
    ("materialrefgs_torch.train.warp", "calc_warp_loss", "warp.calc_warp_loss"),
]


def read(t):
    if not (t.has_span("warp.nearest_render") or t.has_span("warp.calc_warp_loss")):
        return None
    return 1e3 * (t.span_device_s("warp.nearest_render") + t.span_device_s("warp.calc_warp_loss")) / t.units
