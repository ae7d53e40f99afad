"""What the drivers share: seeds, the device's clocks, the check."""

from __future__ import annotations

import gc
from typing import Dict, Optional

import torch


def sub_seed(seed: int, k: int) -> int:
    """The k-th stream of a run's seed (weights, frames, draws, sample)."""
    return (seed * 6364136223846793005 + (k + 1) * 1442695040888963407) % (1 << 63)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference_precision() -> None:
    """Float32 as stated: no TF32 in the reference's convs and matmuls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def backend_flags() -> Dict[str, object]:
    return {"cudnn.benchmark": torch.backends.cudnn.benchmark,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}


def check(readings: Dict[str, float], limits: Dict[str, dict]) -> tuple:
    """(correct, {name: {value, limit}}) over the numbers the limits name:
    each at or under its limit; a limit with no reading, or no limits at
    all, is not correct."""
    out, ok = {}, bool(limits)
    for name in sorted(limits):
        value: Optional[float] = readings.get(name)
        limit = limits[name]["limit"]
        out[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    return ok, out
