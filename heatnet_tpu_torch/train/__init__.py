"""Supervised training: loss, steps, optimizers and schedules, train state."""
