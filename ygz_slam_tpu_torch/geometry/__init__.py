"""Geometry: SO(3)/SE(3)/Sim(3), pinhole camera, projection Jacobians."""

from . import sim3
from .sim3 import Sim3

__all__ = ["Sim3", "sim3"]
