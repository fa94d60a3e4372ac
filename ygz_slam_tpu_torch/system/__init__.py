"""System facade and trajectory tools."""

from . import config, system, trajectory
from .config import Config
from .system import MapType, Sensor, System, VOType

__all__ = ["config", "trajectory", "system", "System", "Sensor", "Config", "VOType", "MapType"]
