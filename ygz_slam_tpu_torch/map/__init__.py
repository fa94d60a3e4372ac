"""The map: the fixed-capacity MapState, its host-side server, the
keyframe archive, the depth filter and the vocabulary."""

from . import memory, state
from .memory import MapServer
from .state import MapState, empty_map

__all__ = ["state", "memory", "MapState", "empty_map", "MapServer"]
