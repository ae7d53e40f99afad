"""Model registry: ``get_model(name, **kw)`` (``heatnet_tpu/models/registry.py``).

Holds what the port has so far; other names raise ``KeyError``.
"""

from __future__ import annotations

from typing import Callable, Dict

from .trgb_segnet import net_resnext50

MODELS: Dict[str, Callable] = {
    "net_resnext50": net_resnext50,
}


def get_model(name: str, **kw):
    """Look up a model factory by name (``models.__dict__[args.arch]`` analog)."""
    if name not in MODELS:
        raise KeyError(f"unknown model {name}; available: {sorted(MODELS)}")
    return MODELS[name](**kw)
