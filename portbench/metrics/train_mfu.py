"""The whole step's share of the card's bf16 peak, in %: the FLOPs of the
forward and backward of every step of the traced run's window outside its profiler spans, counted
once by ``FlopCounterMode`` on the reference at the cell's shapes, over
(those units' host-clock seconds x 989e12). The spans are left out because
the profiler's own host cost slows the loop inside them."""

from portbench.harness.roofline import PEAK_BF16_FLOPS


def read(r):
    units, seconds = r.untraced()
    if r.kind != "train" or seconds <= 0:
        return None
    flops = sum(r.work["flops"].get(u, 0.0) * k for u, k in units.items())
    return 100.0 * flops / (seconds * PEAK_BF16_FLOPS) if flops > 0 else None
