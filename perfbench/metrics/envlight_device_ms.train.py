"""Device milliseconds a step spends building the cubemap's mip chain
(`models.env_light`: EnvLightMips.build, the GGX prefilter, rebuilt every
step) and in its backward: the program's `envlight.mips` span and its
`envlight.mips.bwd` twin."""


def read(t):
    if not t.has_span("envlight.mips"):
        return None
    return 1e3 * (t.span_device_s("envlight.mips") + t.span_device_s("envlight.mips.bwd")) / t.units
