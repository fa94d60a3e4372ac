"""Geometry: SO(3)/SE(3)/Sim(3), pinhole camera, projection Jacobians."""

from . import jacobians, se3, sim3, so3, triangulation
from .camera import PinholeCamera
from .se3 import SE3
from .sim3 import Sim3

__all__ = ["so3", "se3", "sim3", "Sim3", "jacobians", "triangulation", "SE3", "PinholeCamera"]
