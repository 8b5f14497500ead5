"""The rasterizer forward kernel's share of its roofline over the window: the
bound of the window's rasterize_tiles_fwd launches (the work of a view
counted by perfbench/cost on a sample of the window's views, times the
views) over that kernel's device time."""
KERNELS = r"\brasterize_fwd_kernel\b"


def read(t):
    seconds = t.kernel_s(KERNELS)
    if seconds <= 0 or "raster_fwd_s" not in t.cost:
        return None
    return 100.0 * t.units * t.cost["raster_fwd_s"] / seconds
