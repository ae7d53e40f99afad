"""One run of one cell: the driver its traffic names, then the result line."""

from __future__ import annotations

import math
import sys
from typing import Dict, List

import torch

from . import common, serve, train
from .manifest import Cell, read_metrics

DRIVERS = {"serve_closed_loop": serve.run, "train_steps": train.run}

FORBIDDEN = ("jax", "jaxlib", "flax", "heatnet_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``heatnet_tpu_torch`` is not ``heatnet_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _launch_counts() -> Dict[str, int]:
    from heatnet_tpu_torch.ops import fused_preproc, grouped_conv
    return {k.name: k.launches for k in (fused_preproc.INGEST, grouped_conv.GROUPED_CONV3X3,
                                         grouped_conv.GROUPED_CONV3X3_FUSED,
                                         grouped_conv.GROUPED_CONV3X3_DX)}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_process: float, control: str = "", log=print) -> dict:
    """Run the cell and return the result object (without printing it)."""
    log(f"backend flags as the program leaves them: {common.backend_flags()}")
    out = DRIVERS[cell.traffic["kind"]](cell, seed, seconds, trace, device, control)
    log(f"port kernel launches: {_launch_counts()}")
    if "host_ms" in out:
        log(f"host ms per untraced batch: {out['host_ms']} (in the predict call; then "
            f"bringing the maps back, which waits for the card; the mean latency of the "
            f"window's first and second halves)")
    setup_s = out["window_start"] - t_process
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        values = read_metrics([m["name"] for m in cell.per_layer], out["readout"])
    else:
        values = dict(out["end_to_end"], setup_s=setup_s)
        values = {m["name"]: values.get(m["name"]) for m in cell.end_to_end}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items()
               if v is not None and math.isfinite(v)}
    correct, check = common.check(out["readings"], cell.limits)
    log(f"diagnostics (not compared): "
        f"{ {k: v for k, v in out['readings'].items() if k not in check} }")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        r = out["readout"]
        dev["busy_s"], dev["window_s"] = r.busy_s, r.window_s
        result["breakdown"] = r.breakdown()
        units, seconds = r.untraced()
        untraced = seconds / max(sum(units.values()), 1)
        dev_ms = 1e3 / max(r.kind_units["device"], 1)
        host_ms = 1e3 * r.kind_wall_s["host"] / max(r.kind_units["host"], 1)
        log(f"traced spans: {r.spans}, units {dict(r.units)}; ms per unit: the card's window "
            f"{r.window_s * dev_ms:.3f} and busy {r.busy_s * dev_ms:.3f} in the device spans; "
            f"the host {host_ms:.3f} in the host spans, profiler start and stop included; "
            f"the host {1e3 * untraced:.3f} outside the spans")
    result["check"] = check
    return result


def check_lines(check: Dict[str, dict]) -> List[str]:
    return [f"check {k}: {v['value']} limit {v['limit']}" for k, v in check.items()]
