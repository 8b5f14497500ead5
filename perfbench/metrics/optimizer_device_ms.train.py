"""Device milliseconds a step spends in its optimizer updates
(`train.optim`: both Adam steps and the densification statistics), the
program's `update.adam` span."""


def read(t):
    if not t.has_span("update.adam"):
        return None
    return 1e3 * t.span_device_s("update.adam") / t.units
