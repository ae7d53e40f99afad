"""Device time of host-to-device copies per batch, in ms, from the trace's spans."""


def read(r):
    if r.kind != "serve" or not r.n_units:
        return None
    t = r.named_s("memcpy htod")
    return 1e3 * t / r.n_units if t > 0 else None
