"""Validators (Freiburg, MFNet, BDD), the confusion-matrix IoU metric, and
batched inference to class maps."""
