"""Solvers: robust costs, the Gauss-Newton / Levenberg-Marquardt engine
(`nlls`), bundle adjustment (pose-only, point-only, local, two-view,
`optimize_current`), the two-view initializer, P3P-RANSAC and the pose
graphs."""

import importlib

# The JAX package's re-exports, each imported at its first use: the kernel
# modules import `solvers.robust`, and `ba` imports the kernel modules, so
# importing `ba` here would close a cycle.
_FROM = {"gauss_newton": "nlls", "levenberg_marquardt": "nlls",
         "initialize_two_view": "initializer", "ransac_hf": "initializer",
         **{name: "ba" for name in ("Observations", "pose_only_ba", "point_only_ba",
                                    "optimize_current", "local_ba", "two_view_ba")}}

__all__ = ["robust", "nlls", "ba", "gauss_newton", "levenberg_marquardt", "Observations",
           "pose_only_ba", "point_only_ba", "optimize_current", "local_ba", "two_view_ba"]


def __getattr__(name: str):
    if name in ("robust", "nlls", "ba", "initializer"):
        return importlib.import_module(f"{__name__}.{name}")
    if name in _FROM:
        return getattr(importlib.import_module(f"{__name__}.{_FROM[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
