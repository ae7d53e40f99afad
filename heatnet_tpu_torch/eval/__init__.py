"""Batched inference to class maps."""
