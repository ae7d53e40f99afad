"""The int8 conv's card time per layer shape, this tree against another.

    python -m heatnet_tpu_torch.tools.int8_compare --other DIR [--out FILE]

The layer shapes are those a batch-8 int8 forward of ResNeXt-50 (early
fusion, 320x960) quantizes, chosen by JAX's predicates (``jax_int8_layers``,
which ``chip_smoke.py`` phase 9 uses too). Each tree's ``chip_smoke.py
--int8-card-times`` child (phase 9a's) reads them in its own process, in the
order other, this, this, other, on the same card: the other tree is an
unpacked checkout of another commit (``git archive``), under a directory
``.gitignore`` lists. Prints the card, one line per shape (ms per call of
each run, on post-ReLU and signed x) and the sums per forward, and writes
every reading to ``--out`` as JSON. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import Callable, Dict, List, Tuple

import torch

Config = Tuple[int, int, int, int, int, int, int, int, int, int]


def jax_int8_layers(model: torch.nn.Module, forward: Callable[[], object]
                    ) -> Tuple[Dict[str, tuple], List[str], Dict[Config, List[str]]]:
    """The conv() layers of a float ResNeXtSeg that JAX quantizes, from the
    layers' inputs in one ``forward()`` and JAX's predicates: ``Int8Conv``
    serves int8 at H*W <= 100_000 (layers.py:826) and batch >= 8
    (``_int8_batch_ok``); ``GroupedConvDense``'s int8 arm runs unless cpg >= 4
    and N*H*W*cpg >= 400_000 (the native form, layers.py:458-507), at batch
    >= 8. Returns (input shape per conv() layer, the quantized layers' names,
    their names by config (cin, cout, k, stride, pad, dilation, groups, n, h,
    w))."""
    from ..models.layers import GroupedConv

    shapes, hooks = {}, []

    def record(name):
        def hook(mod, args):
            shapes.setdefault(name, tuple(args[0].shape))
        return hook

    for name, m in model.named_modules():
        if isinstance(m, GroupedConv) or getattr(m, "int8_ok", False):
            hooks.append(m.register_forward_pre_hook(record(name)))
    try:
        forward()
    finally:
        for h in hooks:
            h.remove()

    def quantizes(name, shape):
        n, c, h, w = shape
        m = model.get_submodule(name)
        if isinstance(m, GroupedConv):
            cpg = c // m.groups
            return not (cpg >= 4 and n * h * w * cpg >= 400_000) and n >= 8
        return h * w <= 100_000 and n >= 8

    q_layers = [k for k, s in shapes.items() if quantizes(k, s)]
    configs: Dict[Config, List[str]] = {}
    for name in q_layers:
        m = model.get_submodule(name)
        n, c, h, w = shapes[name]
        if isinstance(m, GroupedConv):
            key = (c, c, 3, 1, m.dilation, m.dilation, m.groups, n, h, w)
        else:
            key = (c, m.out_channels, m.kernel_size[0], m.stride[0], m.padding[0],
                   m.dilation[0], 1, n, h, w)
        configs.setdefault(key, []).append(name)
    return shapes, q_layers, configs


def forward_configs(dev: torch.device) -> Dict[Config, List[str]]:
    """``jax_int8_layers`` of a float ResNeXt-50 (seed-0 weights) on one
    batch-8 320x960 forward."""
    from ..models import get_model
    from ..models.layers import init_params, prepare_for_inference

    model = get_model("net_resnext50", classes=13, input_channels=4)
    init_params(model, torch.Generator().manual_seed(0))
    model = prepare_for_inference(model, dev)
    x = torch.zeros((8, 320, 960, 4), device=dev, dtype=model.compute_dtype)
    with torch.no_grad():
        return jax_int8_layers(model, lambda: model(x))[2]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--other", required=True, help="another tree's root (git archive)")
    p.add_argument("--out", default=None, help="JSON of every reading")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("int8_compare: no card (torch.cuda.is_available() is false)")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    trees = {"other": os.path.abspath(args.other), "this": here}
    configs = forward_configs(torch.device("cuda"))
    runs = []
    with tempfile.TemporaryDirectory() as work:
        spec = os.path.join(work, "spec.json")
        with open(spec, "w") as f:
            json.dump({"configs": list(configs), "frame": [320, 960]}, f)
        for i, tag in enumerate(("other", "this", "this", "other")):
            out = os.path.join(work, f"run{i}.json")
            script = os.path.join(trees[tag], "chip_smoke.py")
            child = subprocess.run([sys.executable, script, "--int8-card-times", spec, out],
                                   cwd=trees[tag],
                                   capture_output=True, text=True, timeout=600)
            if child.returncode != 0:
                sys.exit(f"int8_compare: {tag} run {i}: rc {child.returncode}\n"
                         f"{child.stderr[-3000:]}")
            with open(out) as f:
                runs.append((tag, json.load(f)))
    per_fwd = [len(names) for names in configs.values()]
    for j, (cfg, names) in enumerate(configs.items()):
        cells = []
        for tag, r in runs:
            row = r["layers"][j]
            cells.append(f"{tag} " + " / ".join(
                "-" if row[x][0] is None else f"{row[x][0]:.4f}"
                for x in ("relu", "signed")))
        print(f"{cfg} x{len(names)} ({names[0]}): " + "; ".join(cells), flush=True)
    for tag, r in runs:
        sums = [None if any(row[x][0] is None for row in r["layers"]) else
                sum(k * row[x][0] for k, row in zip(per_fwd, r["layers"]))
                for x in ("relu", "signed")]
        fwd = r["forward"][0]
        print(f"{tag}: per forward, post-ReLU / signed x: "
              + " / ".join("not measured" if v is None else f"{v:.4f}" for v in sums)
              + " ms; in one int8 forward: "
              + ("not measured" if fwd is None else f"{fwd:.4f}") + " ms", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"configs": [[list(c), n] for c, n in configs.items()],
                       "runs": runs}, f)


if __name__ == "__main__":
    main()
