"""Experiment configs; visualisation: label colour coding, an IR colormap, PNG dumps."""
