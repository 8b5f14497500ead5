"""The rasterizer kernels' share of their roofline over the window: the
bound of the window's rasterize_tiles_fwd and _bwd launches (the work of a
step counted by perfbench/cost on a sample of the window's views, times the
steps) over those kernels' device time."""
KERNELS = r"\brasterize_(fwd|bwd)_kernel\b"


def read(t):
    seconds = t.kernel_s(KERNELS)
    if seconds <= 0 or "raster_fwd_s" not in t.cost:
        return None
    return 100.0 * t.units * (t.cost["raster_fwd_s"] + t.cost["raster_bwd_s"]) / seconds
