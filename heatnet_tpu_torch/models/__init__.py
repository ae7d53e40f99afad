"""Ported models (eval and train mode, NCHW channels_last inside, NHWC at the surface)."""

from .conf_segnet import ConfSegnet
from .cyclegan import Discriminator, Generator
from .extractors import (DenseNetExtractor, SqueezeNetExtractor, make_extractor,
                         make_resnet)
from .layers import NormAct
from .mfnet import MFNet
from .pspnet import PSPNet
from .registry import MODELS, build_network, get_model
from .rtfnet import RTFNet
from .segnet_baseline import SegNetBaseline
from .segnetsplit import ResNeXtDecoder, ResNeXtEncoder
from .trgb_segnet import (ResNeXtSeg, net_resnext50, net_resnext101, net_resnext152,
                          tap_channels)
from .unet import UNetAdapter, UNetSeg

__all__ = [
    "ConfSegnet", "DenseNetExtractor", "Discriminator", "Generator",
    "NormAct", "MFNet", "PSPNet", "MODELS", "build_network", "get_model",
    "make_extractor", "make_resnet", "RTFNet", "ResNeXtDecoder",
    "ResNeXtEncoder", "ResNeXtSeg", "SegNetBaseline", "SqueezeNetExtractor",
    "net_resnext50", "net_resnext101", "net_resnext152", "tap_channels",
    "UNetAdapter", "UNetSeg",
]
