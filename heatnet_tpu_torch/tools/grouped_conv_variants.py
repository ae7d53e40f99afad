"""Time the grouped-conv kernel against one-line variants of its source.

    python -m heatnet_tpu_torch.tools.grouped_conv_variants    (needs a card)

Each variant is ``csrc/grouped_conv3x3.cu`` with one text substitution,
built by ``nvcc`` into its own library under ``_build/variants`` and called
through the same C entry, so two launch rules or tile shapes compare in one
process on one card. Every variant is checked against the plain version
(one bf16 step) before it is timed. Times are CUDA-event means of 50
back-to-back launches, best of 3, at the serving (batch 8) and training
(batch 10) shapes, fused relu epilogue. The variants:

- ``as_built``: the source as it is;
- ``two_per_sm``: up to two resident blocks per SM at every dilation;
- ``one_per_sm``: one block per SM at every dilation.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from ..kernels import build
from ..ops import grouped_conv as gc

RULE = "slots = sms * (dil >= 4 ? 1 : per_sm);"
VARIANTS = {
    "as_built": None,
    "two_per_sm": (RULE, "slots = sms * per_sm;"),
    "one_per_sm": (RULE, "slots = sms;"),
}
# (name, N, H, W, C, cpg, dilation)
SHAPES = (("mod2", 8, 80, 176, 128, 2, 1), ("mod3", 8, 40, 88, 256, 4, 1),
          ("mod4", 8, 40, 88, 512, 8, 2), ("mod5", 8, 40, 88, 1024, 16, 4),
          ("mod2 train", 10, 80, 160, 128, 2, 1), ("mod3 train", 10, 40, 80, 256, 4, 1),
          ("mod4 train", 10, 40, 80, 512, 8, 2), ("mod5 train", 10, 40, 80, 1024, 16, 4))
HBM_BYTES_PER_S = 3.35e12


def _build(out_dir: str) -> dict:
    with open(os.path.join(build.CSRC, "grouped_conv3x3.cu")) as f:
        src = f.read()
    procs = {}
    for name, sub in VARIANTS.items():
        text = src
        if sub is not None:
            if src.count(sub[0]) != 1:
                raise RuntimeError(f"variant {name}: {sub[0]!r} not found once")
            text = src.replace(*sub)
        cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", cu, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{out}")
        fn = ctypes.CDLL(so).hn_grouped_conv3x3
        fn.argtypes, fn.restype = gc._ARGTYPES, ctypes.c_int
        fns[name] = fn
    return fns


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("grouped_conv_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    fns = _build(out_dir)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for name, n, h, w, c, cpg, d in SHAPES:
        g = torch.Generator().manual_seed(c)
        x = torch.randn((n, h, w, c), generator=g).to(dev, torch.bfloat16)
        wt = (torch.randn((c, cpg, 3, 3), generator=g) / (9 * cpg) ** 0.5).to(
            dev, torch.bfloat16)
        s = (torch.rand(c, generator=g) + 0.5).to(dev)
        b = (torch.randn(c, generator=g) * 0.1).to(dev)
        ref = gc.grouped_conv3x3_plain(x, wt, c // cpg, d, s, b, "relu").float()
        bound = 2 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3
        line = f"{name:11s} bound_ms {bound:.4f}"
        for vname, fn in fns.items():
            out = torch.empty_like(x)
            args = (x.data_ptr(), wt.data_ptr(), s.data_ptr(), b.data_ptr(),
                    out.data_ptr(), n, h, w, c, cpg, d, 0, gc.ACTS["relu"], 0.0, stream)
            if fn(*args) != 0:
                sys.exit(f"{vname} refused to launch at {name}")
            torch.cuda.synchronize()
            if not bool(((out.float() - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-3).all()):
                sys.exit(f"{vname} disagrees with the plain version at {name}")
            for _ in range(5):
                fn(*args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            best = float("inf")
            for _ in range(3):
                start.record()
                for _ in range(50):
                    fn(*args)
                end.record()
                torch.cuda.synchronize()
                best = min(best, start.elapsed_time(end) / 50)
            line += f"  {vname} {best:.4f} ({bound / best:.2f} of bound)"
        print(line, flush=True)


if __name__ == "__main__":
    main()
