"""Ported models (eval and train mode, NCHW channels_last inside, NHWC at the surface)."""

from .layers import NormAct
from .registry import MODELS, get_model
from .trgb_segnet import ResNeXtSeg, net_resnext50

__all__ = ["MODELS", "NormAct", "ResNeXtSeg", "get_model", "net_resnext50"]
