"""Device time per step, in ms, of batch norm and the elementwise and
reduce kernels (activations, residual adds, casts, losses)."""


def read(r):
    if r.kind != "train" or not r.n_units:
        return None
    t = r.family_s("batch norm", "elementwise / reduce")
    return 1e3 * t / r.n_units if t > 0 else None
