"""Synthetic scenes with exact ground truth."""

from . import synthetic

__all__ = ["synthetic"]
