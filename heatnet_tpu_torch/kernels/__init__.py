"""Build and binding of the CUDA sources under ``csrc/``."""
