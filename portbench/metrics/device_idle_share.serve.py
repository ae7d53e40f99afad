"""Share of the traced window, in %, in which no kernel or copy ran on the
device: 1 - busy / window, summed over the device spans alone (the profiler
records the card's activity there and no host op, so the host runs near its
untraced pace; ``harness/trace.py``). The window is the card's clock between
two CUDA events at each span's ends. The profiler's activity records still
cost the host a little per launch: where the host paces the loop, the window
per unit there runs up to about a tenth longer than the host's time per unit
outside the spans, and the share reads a few points high."""


def read(r):
    if r.kind != "serve" or r.window_s <= 0 or r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
