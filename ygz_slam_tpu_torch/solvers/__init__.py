"""Solvers: robust costs and pose-only bundle adjustment."""
