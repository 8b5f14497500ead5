"""The share of the window in which no operation ran on the device: 100
minus the union of the device's kernel and copy time over the window."""


def read(t):
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
