"""Ingest and grouped-conv ops (CUDA kernels with their plain versions),
the int8 conv, the train augmentation chain and IoU. Importing the package
registers the kernels as ``torch.ops.heatnet.*`` (``library``)."""

from . import library  # noqa: F401
