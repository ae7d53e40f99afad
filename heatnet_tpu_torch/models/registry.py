"""Model registry: ``get_model(name, **kw)`` and the PSPNet factory
``build_network`` (``heatnet_tpu/models/registry.py:23-68``).

Every name of the JAX registry. A flax module infers its input width; a
PyTorch one needs it, so the three whose input width the JAX factories do
not name take it as a keyword with a default: ``cyclegan_discriminator``
and ``unet_seg`` ``in_channels=1`` (IR, as the CycleGAN nets take it),
``unet_adapter`` ``in_channels=4`` (early-fusion RGB + IR).
"""

from __future__ import annotations

from typing import Callable, Dict

from .cyclegan import Discriminator, Generator
from .mfnet import MFNet
from .pspnet import PSPNet
from .rtfnet import RTFNet
from .segnet_baseline import SegNetBaseline
from .trgb_segnet import net_resnext50, net_resnext101, net_resnext152
from .unet import UNetAdapter, UNetSeg

_PSP_BACKENDS = {
    # psp_size per backend (build_net.py:7-16)
    "squeezenet": 512,
    "densenet": 1024,
    "resnet18": 512,
    "resnet34": 512,
    "resnet50": 2048,
    "resnet101": 2048,
    "resnet152": 2048,
}


def build_network(backend: str = "resnet50", n_classes: int = 13,
                  in_channels: int = 3, late_fusion: bool = False) -> PSPNet:
    """PSPNet on any of the 7 backends (build_net.py:7-28; snapshot loading
    is the caller's)."""
    backend = backend.lower()
    if backend not in _PSP_BACKENDS:
        raise KeyError(f"unknown PSPNet backend {backend}")
    return PSPNet(n_classes=n_classes, psp_size=_PSP_BACKENDS[backend],
                  backend=backend, in_channels=in_channels, late_fusion=late_fusion)


MODELS: Dict[str, Callable] = {
    "net_resnext50": net_resnext50,
    "net_resnext101": net_resnext101,
    "net_resnext152": net_resnext152,
    "pspnet": build_network,
    "mfnet": lambda **kw: MFNet(**kw),
    "rtfnet": lambda **kw: RTFNet(**kw),
    "segnet_baseline": lambda **kw: SegNetBaseline(**kw),
    "cyclegan_generator": lambda **kw: Generator(**kw),
    "cyclegan_discriminator": lambda in_channels=1: Discriminator(in_channels),
    "unet_adapter": lambda in_channels=4, **kw: UNetAdapter(in_channels, **kw),
    "unet_seg": lambda **kw: UNetSeg(**kw),
}


def get_model(name: str, **kw):
    """Look up a model factory by name (``models.__dict__[args.arch]`` analog)."""
    if name not in MODELS:
        raise KeyError(f"unknown model {name}; available: {sorted(MODELS)}")
    return MODELS[name](**kw)
