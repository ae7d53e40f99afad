"""Conversion of JAX parameter trees into the port's ``state_dict``."""
