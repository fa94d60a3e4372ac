"""Solvers: robust costs, the Gauss-Newton / Levenberg-Marquardt engine
(`nlls`), bundle adjustment (pose-only, point-only, local, two-view,
`optimize_current`), the two-view initializer, P3P-RANSAC and the pose
graphs."""
