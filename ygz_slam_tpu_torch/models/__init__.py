"""The tracking, mapping and VO modules, and the workloads that drive them."""

from . import frontend, local_mapping, orb_tracking, semidense, visual_odometry
from .visual_odometry import MapType, Status, VisualOdometry, VOOptions, VOType

__all__ = ["frontend", "local_mapping", "orb_tracking", "semidense", "visual_odometry",
           "VisualOdometry", "VOOptions", "Status", "VOType", "MapType"]
