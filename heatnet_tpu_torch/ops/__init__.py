"""Ingest and grouped-conv ops: CUDA kernels with their plain versions."""
