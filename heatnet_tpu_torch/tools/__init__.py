"""Measurement scripts that run the port on the card."""
