"""Ingest and grouped-conv ops (CUDA kernels with their plain versions),
the train augmentation chain and IoU."""
