"""Synthetic scenes with exact ground truth."""
