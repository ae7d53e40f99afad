"""Cells cut to a size a CPU test can run: structure (1, 1, 1, 1), small
frames and batches, the cell's own limits."""

from __future__ import annotations

import copy
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench.harness import cell as runner  # noqa: E402
from portbench.harness.manifest import Cell, load  # noqa: E402

SEED = 2**31 + 11


def tiny_cell(name: str, root: str = ROOT) -> Cell:
    c = Cell(load(root), name, root)
    c.config = copy.deepcopy(c.config)
    c.traffic = copy.deepcopy(c.traffic)
    c.config["segnet"]["structure"] = [1, 1, 1, 1]
    t = c.traffic
    if t["kind"] == "serve_closed_loop":
        t.update(batch=2, height=64, width=96, pool=3, warmup_batches=1)
        t["check"] = {"batches": 2, "block": 2}
        t["trace"] = {"every": 3, "active": 2}
    else:  # the critics' five stride-2 convs want 256-pixel crops
        t.update(batch=2, height=256, width=960, crop=[256, 256], pool=2)
        t["trace"] = {"every_blocks": 1}
        t["block_steps"] = 1
        c.config["schedule"] = {"iter_critic_phase": 1, "iter_seg_phase": 1,
                                "iter_initial_critic_phase": 1}
    return c


def run_tiny(name: str, trace: bool = False, control: str = "", seed: int = SEED,
             root: str = ROOT) -> dict:
    return runner.run(tiny_cell(name, root), seed, 0.2, trace, torch.device("cpu"),
                      time.time(), control=control, log=lambda s: None)
