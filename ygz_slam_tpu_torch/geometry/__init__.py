"""Geometry: SO(3)/SE(3), pinhole camera, projection Jacobians."""
