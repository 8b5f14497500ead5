"""Device milliseconds a step spends in its loss terms other than the warp
(`train.losses`: calculate_loss, the regularizers) and their backward: the
program's `losses` span and its `losses.bwd` twin."""


def read(t):
    if not t.has_span("losses"):
        return None
    return 1e3 * (t.span_device_s("losses") + t.span_device_s("losses.bwd")) / t.units
