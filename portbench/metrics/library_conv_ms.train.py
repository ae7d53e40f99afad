"""Device time per step, in ms, of the cuDNN/cuBLAS convolution and matmul
kernels (the yardstick's frozen family rules, ``harness/roofline.py``)."""


def read(r):
    if r.kind != "train" or not r.n_units:
        return None
    t = r.family_s("cuDNN/cuBLAS conv")
    return 1e3 * t / r.n_units if t > 0 else None
