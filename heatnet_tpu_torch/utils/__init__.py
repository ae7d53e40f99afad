"""Visualisation: label colour coding, an IR colormap, PNG dumps."""
