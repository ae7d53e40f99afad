"""Ported models (eval and train mode, NCHW channels_last inside, NHWC at the surface)."""

from .conf_segnet import ConfSegnet
from .layers import NormAct
from .registry import MODELS, get_model
from .trgb_segnet import ResNeXtSeg, net_resnext50

__all__ = ["MODELS", "ConfSegnet", "NormAct", "ResNeXtSeg", "get_model",
           "net_resnext50"]
