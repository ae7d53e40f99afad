"""Ported models (eval and train mode, NCHW channels_last inside, NHWC at the surface)."""

from .conf_segnet import ConfSegnet
from .layers import NormAct
from .pspnet import PSPNet
from .registry import MODELS, build_network, get_model
from .trgb_segnet import ResNeXtSeg, net_resnext50, net_resnext101, net_resnext152

__all__ = ["MODELS", "ConfSegnet", "NormAct", "PSPNet", "ResNeXtSeg",
           "build_network", "get_model", "net_resnext50", "net_resnext101",
           "net_resnext152"]
