"""The grouped 3x3 conv kernels' share of their roofline, in %: the sum of
their bounds over the traced batches (the configuration's 16 grouped convs
forward, fused epilogue included, counted on the reference) over the device
time of the kernels named here."""

KERNELS = ("grouped_conv3x3",)


def read(r):
    if r.kind != "serve":
        return None
    t = r.named_s(*KERNELS)
    bound = sum(r.work["bound.grouped_conv3x3"].get(u, 0.0) * k for u, k in r.units.items())
    return 100.0 * bound / t if t > 0 and bound > 0 else None
