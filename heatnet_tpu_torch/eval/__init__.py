"""Validators (Freiburg, MFNet, BDD) and batched inference to class maps."""
