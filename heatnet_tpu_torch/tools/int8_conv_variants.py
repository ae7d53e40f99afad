"""Time the int8 conv kernel against one-line variants of its source.

    python -m heatnet_tpu_torch.tools.int8_conv_variants    (needs a card)

Each variant is ``csrc/int8_conv.cu`` with a few text substitutions, built by
``nvcc`` into its own library under ``_build/int8_variants`` and called
through the port's wrapper (``ops/int8_conv.py``, its C entry swapped), so
tile and pipeline choices compare in one process on one card. A variant
marked exact is checked against the plain version bit for bit before it is
timed; the others take work out (the products, the epilogue) to show where
the time goes and are timed only. Times are the card time of each kernel
(torch.profiler, 10 calls), quantize pass and product apart, at some of the
int8 layer shapes of a batch-8 forward at 320x960 (post-ReLU x).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from ..kernels import build
from ..ops import int8_conv

WGMMA = ("      for (int kk = 0; kk < kBK / 32; ++kk) "
         "wgmma<BN>(acc[u], da + 2 * kk, db + 2 * kk);")
EPILOGUE = ('  asm volatile("bar.sync 1, 256;\\n" ::: "memory");\n'
            "  constexpr int kRow = stage_row_bytes(BN);")
BN_RULE = ("const int bn = cout_g >= 256 && cout_g % 256 == 0 ? 256 : cout_g >= 128 ? 128 "
           ": 64;")
BN128 = "const int bn = cout_g >= 128 ? 128 : 64;"
# name: (substitutions, exact)
VARIANTS = {
    "as_built": ((), True),
    "no_mma": (((WGMMA, WGMMA.replace("kk < kBK / 32", "kk < 0")),), False),
    "no_epilogue": (((EPILOGUE, "  if (p.m > 0) return;\n" + EPILOGUE),), False),
    "bn128": (((BN_RULE, BN128),), True),
    "bm128": ((("const int bm = bn == 128 ? 256 : 128;", "const int bm = 128;"),
               ("launch_gemm<128, 256>", "launch_gemm<128, 128>")), True),
}
# (cin, cout, k, stride, dilation, groups, n, h, w)
SHAPES = ((1024, 2048, 1, 1, 1, 1, 8, 40, 120), (512, 1024, 1, 1, 1, 1, 8, 40, 120),
          (64, 256, 1, 1, 1, 1, 8, 80, 240), (128, 256, 1, 1, 1, 1, 8, 80, 240),
          (2048, 256, 1, 1, 1, 1, 8, 1, 1), (64, 64, 3, 1, 1, 1, 8, 160, 480),
          (2048, 256, 3, 1, 12, 1, 8, 40, 120), (269, 269, 3, 1, 1, 1, 8, 80, 240),
          (128, 128, 3, 1, 1, 64, 8, 80, 240), (512, 512, 3, 1, 2, 64, 8, 40, 120),
          (256, 128, 1, 1, 1, 1, 8, 80, 240), (269, 13, 3, 1, 1, 1, 8, 80, 240))


def _build(out_dir: str) -> dict:
    with open(os.path.join(build.CSRC, "int8_conv.cu")) as f:
        src = f.read()
    procs = {}
    for name, (subs, _) in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} not found once")
            text = text.replace(old, new)
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
        fn = ctypes.CDLL(so).hn_int8_conv
        fn.argtypes, fn.restype = int8_conv.INT8_CONV.argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def _card_ms(call, calls: int = 10):
    """(quantize, product) card ms per call, or None where records were lost."""
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    recs = [e for e in prof.events()
            if e.device_type.name == "CUDA" and "int8_conv" in e.name]
    q = [e.device_time_total for e in recs if "int8_conv_quantize" in e.name]
    g = [e.device_time_total for e in recs if "int8_conv_gemm" in e.name]
    if len(q) != calls or len(g) != calls:
        return None
    return sum(q) / 1e3 / calls, sum(g) / 1e3 / calls


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("int8_conv_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    out_dir = os.path.join(build.BUILD_DIR, "int8_variants")
    os.makedirs(out_dir, exist_ok=True)
    fns = _build(out_dir)
    dev = torch.device("cuda")
    kernel = int8_conv.INT8_CONV
    for cin, cout, k, s, d, groups, n, h, w in SHAPES:
        g = torch.Generator().manual_seed(cin + cout)
        x = torch.relu(torch.randn((n, h, w, cin), generator=g) * 2).to(dev, torch.bfloat16)
        x = x.permute(0, 3, 1, 2)
        w_q, w_scale = int8_conv.quantize_weight(torch.randn((cout, cin // groups, k, k),
                                                             generator=g))
        w_q, w_scale = w_q.to(dev), w_scale.to(dev)
        w_pack = int8_conv.pack_weight(w_q, groups)
        x_scale = (x.float().amax() / 100).reshape(())
        args = (w_scale, x_scale, None, s, d * (k // 2), d, groups)
        ref = int8_conv.int8_conv2d_plain(x, w_q, *args)
        line = f"{cin}->{cout} {k}x{k} s{s} d{d} g{groups} at {n}x{h}x{w}:"
        for name, fn in fns.items():
            kernel._fn = fn
            call = lambda: int8_conv.int8_conv2d(x, w_q, w_pack, *args)  # noqa: E731
            if VARIANTS[name][1]:
                out = call()
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    sys.exit(f"{name} disagrees with the plain version at {line}")
            t = _card_ms(call)
            line += f"  {name} " + ("lost records" if t is None else
                                    f"q {t[0]:.4f} + gemm {t[1]:.4f}")
        kernel._fn = None
        print(line, flush=True)


if __name__ == "__main__":
    main()
