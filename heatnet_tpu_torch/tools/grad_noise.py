"""How far rounding alone moves one training step's gradients on the card.

    python -m heatnet_tpu_torch.tools.grad_noise [--batch 10]

ResNeXt-50 (random weights, seed 0), one batch of 320x640 crops (the
``chip_smoke.py`` train data: random frames, banded labels), one step's
loss and parameter gradients (no optimizer step) computed five ways:

- ``kernel``: the port as it runs (bf16 activations, the CUDA grouped conv);
- ``plain``: the grouped conv's forward and dx through its plain version;
- ``library``: through ``F.conv2d`` / ``conv2d_input`` (cuDNN, bf16);
- ``f32``: float32 activations, the library's grouped conv, TF32 off;
- ``f32_perturbed``: as ``f32`` with the RGB input times (1 + 1e-4 N(0,1)).

Prints the card and one JSON line: the losses, and per stage (mod1..mod5,
head) the largest relative L2 distance of each pair over the gradient
tensors of norm >= 1e-4. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

PAIRS = (("kernel", "plain"), ("library", "plain"), ("kernel", "f32"),
         ("plain", "f32"), ("f32_perturbed", "f32"))
STAGES = ("mod1", "mod2", "mod3", "mod4", "mod5", "head")


def main(argv=None) -> None:
    from ..data.loaders import DeviceAugment
    from ..models import get_model
    from ..ops import grouped_conv as gc
    from ..train.state import init_model
    from ..train.supervised import cross_entropy_ignore

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grad_noise needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0])

    rng = np.random.RandomState(2)
    n, h, w = args.batch, 320, 960
    bands = (np.arange(h)[:, None] // 64 + np.arange(w)[None, :] // 192) % 13
    raw = {"rgb_day": rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
           "ir_day": rng.randint(21000, 26000, (n, h, w)).astype(np.uint16),
           "label_day": np.broadcast_to(bands, (n, h, w)).astype(np.uint8),
           "rgb_night": rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
           "ir_night": rng.randint(21000, 26000, (n, h, w)).astype(np.uint16)}
    batch = DeviceAugment((320, 640), dev)(torch.Generator().manual_seed(1), raw)

    model = init_model(get_model("net_resnext50", classes=13, input_channels=4), 0, dev)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def fwd_plain(x, w, groups, dilation=1):
        return gc.grouped_conv3x3_plain(x, w, groups, dilation)

    def dx_plain(dy, w, groups, dilation=1):
        return gc.grouped_conv3x3_plain(dy, gc.dx_weight(w, groups), groups, dilation)

    def fwd_library(x, w, groups, dilation=1):
        return F.conv2d(x.permute(0, 3, 1, 2), w, padding=dilation,
                        dilation=dilation, groups=groups).permute(0, 2, 3, 1)

    def dx_library(dy, w, groups, dilation=1):
        n_, h_, w_, c = dy.shape
        return torch.nn.grad.conv2d_input(
            (n_, c, h_, w_), w, dy.permute(0, 3, 1, 2), padding=dilation,
            dilation=dilation, groups=groups).permute(0, 2, 3, 1)

    def step(conv=None, dtype=torch.bfloat16, rgb_noise=0.0):
        rgb = batch["rgb_day"]
        if rgb_noise:
            g = torch.Generator(device=dev).manual_seed(5)
            rgb = rgb * (1 + rgb_noise * torch.randn(rgb.shape, generator=g, device=dev))
        model.load_state_dict(start)
        model.zero_grad(set_to_none=True)
        model.compute_dtype = dtype
        with mock.patch.object(gc, "grouped_conv3x3", conv[0] if conv else gc.grouped_conv3x3), \
                mock.patch.object(gc, "grouped_conv3x3_dx", conv[1] if conv else gc.grouped_conv3x3_dx):
            seg = model(rgb, batch["ir_day"])[0]
            loss = cross_entropy_ignore(seg, batch["label_day"], ignore_index=-1)
            loss.backward()
        model.compute_dtype = torch.bfloat16
        return float(loss.detach()), {k: q.grad.float().clone()
                                      for k, q in model.named_parameters()
                                      if q.grad is not None}

    runs = {"kernel": step(), "plain": step((fwd_plain, dx_plain)),
            "library": step((fwd_library, dx_library)),
            "f32": step((fwd_library, dx_library), torch.float32),
            "f32_perturbed": step((fwd_library, dx_library), torch.float32, 1e-4)}
    grads = {k: v[1] for k, v in runs.items()}
    names = [k for k, g in grads["f32"].items() if float(g.norm()) >= 1e-4]

    def stage(name):
        return name.split(".")[0].split("_")[0] if name.startswith("mod") else "head"

    table = {}
    for a, b in PAIRS:
        per = {}
        for k in names:
            rel = float((grads[a][k] - grads[b][k]).norm() / grads[b][k].norm())
            per[stage(k)] = max(per.get(stage(k), 0.0), rel)
        table[f"{a}-{b}"] = {s: per.get(s) for s in STAGES}
    print(json.dumps({"batch": n, "crop": "320x640",
                      "losses": {k: v[0] for k, v in runs.items()},
                      "tensors": len(names),
                      "max_rel_l2_by_stage": table}), flush=True)


if __name__ == "__main__":
    main()
