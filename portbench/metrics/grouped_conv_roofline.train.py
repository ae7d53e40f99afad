"""The grouped 3x3 conv kernels' share of their roofline, in %: the sum of
their bounds over the traced steps (critic step: the segnet's 16 grouped
convs forward, twice; seg step: forward and dx twice, and the teacher's
fused forward; dk is the library's and not counted) over the device time of
the kernels named here."""

KERNELS = ("grouped_conv3x3",)


def read(r):
    if r.kind != "train":
        return None
    t = r.named_s(*KERNELS)
    bound = sum(r.work["bound.grouped_conv3x3"].get(u, 0.0) * k for u, k in r.units.items())
    return 100.0 * bound / t if t > 0 and bound > 0 else None
