"""Gauss-Newton and Levenberg-Marquardt on manifolds (counterpart of
ygz_slam_tpu/solvers/nlls.py; the reference's NLLSSolver, NLSSolver.h:26-150
and NLSSolver_impl.hpp:16-212).

The model is one function compute(x) -> (H [D, D], b [D], chi2), already
accumulated over the residuals, with b = -J^T W r; retract(x, dx) applies
an update on the manifold.  x may be a tensor or a tuple of tensors (an
SE3, a NamedTuple).  Every iteration runs; an iteration after the stop
leaves the state as it is, so the accept, rollback and stop decisions stay
on the device and no step reads a value back to the host.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class SolveStats(NamedTuple):
    chi2: torch.Tensor        # final chi2
    iters: torch.Tensor       # iterations taken
    converged: torch.Tensor   # the update's largest entry fell below eps
    H: torch.Tensor | None = None   # Hessian at the final state (Gauss-Newton only)


def _where(cond: torch.Tensor, a, b):
    """a where cond holds, else b, leaf by leaf over tensors and tuples."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    leaves = [_where(cond, x, y) for x, y in zip(a, b)]
    return type(a)(*leaves) if hasattr(a, "_fields") else type(a)(leaves)


def _solve_spd(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """H dx = b for a small dense SPD H through Cholesky (H + 1e-8 I); a
    factorization that fails or a non-finite step gives dx = 0."""
    D = H.shape[-1]
    L, info = torch.linalg.cholesky_ex(H + 1e-8 * torch.eye(D, dtype=H.dtype, device=H.device))
    dx = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where((info == 0) & torch.all(torch.isfinite(dx)), dx, torch.zeros_like(dx))


def gauss_newton(compute: Callable, retract: Callable, x0, n_iter: int = 10,
                 eps: float = 1e-10):
    """Gauss-Newton with rollback (optimizeGaussNewton,
    NLSSolver_impl.hpp:16-89): solve H dx = b; a step that raises chi2 is
    rolled back and stops the solve, and so does max|dx| < eps.  One
    compute() per iteration, at the trial point (the carried H, b, chi2
    are the current state's).  Returns (x, SolveStats with the final H)."""
    H, b, chi2 = compute(x0)
    x = x0
    stop = chi2 < 0.0               # False, on chi2's device
    converged = stop
    it = torch.zeros((), dtype=torch.int32, device=chi2.device)
    for _ in range(n_iter):
        dx = _solve_spd(H, b)
        x_new = retract(x, dx)
        H_new, b_new, chi2_new = compute(x_new)
        worse = chi2_new > chi2
        conv = torch.max(torch.abs(dx)) < eps
        hold = stop | worse
        x = _where(hold, x, x_new)
        H = torch.where(hold, H, H_new)
        b = torch.where(hold, b, b_new)
        chi2 = torch.where(hold, chi2, chi2_new)
        it = it + (~stop).to(torch.int32)
        converged = converged | (~stop & conv)
        stop = stop | worse | conv
    return x, SolveStats(chi2, it, converged, H)


def levenberg_marquardt(compute: Callable, retract: Callable, x0, n_iter: int = 15,
                        n_trials_max: int = 5, eps: float = 1e-10, mu_init: float = 0.01):
    """Levenberg-Marquardt with the mu/nu schedule of
    optimizeLevenbergMarquardt (NLSSolver_impl.hpp:92-212): a trial is
    accepted when the gain ratio rho > 0 and its chi2 is finite, which
    scales mu by max(1/3, 1 - (2 rho - 1)^3) and resets nu to 2; a rejected
    trial sets mu *= nu, nu *= 2, up to n_trials_max trials per iteration.
    The solve stops after an iteration with no accepted trial, or once an
    accepted step's max|dx| < eps.  Returns (x, SolveStats)."""
    _, _, chi2 = compute(x0)
    x = x0
    stop = chi2 < 0.0
    converged = stop
    mu = torch.full_like(chi2, mu_init)
    nu = torch.full_like(chi2, 2.0)
    it = torch.zeros((), dtype=torch.int32, device=chi2.device)
    for _ in range(n_iter):
        H, b, _ = compute(x)
        eye = torch.eye(b.shape[0], dtype=H.dtype, device=H.device)
        tx, tchi2, tmu, tnu = x, chi2, mu, nu
        accepted = stop & ~stop     # False
        dx_norm = torch.full_like(chi2, torch.inf)
        for _ in range(n_trials_max):
            run = ~stop & ~accepted
            dx = _solve_spd(H + tmu * eye, b)
            x_new = retract(x, dx)
            _, _, chi2_new = compute(x_new)
            pred = 0.5 * torch.dot(dx, tmu * dx + b)
            rho = (chi2 - chi2_new) / torch.clamp(pred, min=1e-12)
            accept = (rho > 0) & torch.isfinite(chi2_new)
            factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
            take = run & accept
            tx = _where(take, x_new, tx)
            tchi2 = torch.where(take, chi2_new, tchi2)
            tmu, tnu = (torch.where(run, torch.where(accept, tmu * factor, tmu * tnu), tmu),
                        torch.where(run, torch.where(accept, torch.full_like(tnu, 2.0),
                                                     tnu * 2.0), tnu))
            dx_norm = torch.where(run, torch.max(torch.abs(dx)), dx_norm)
            accepted = accepted | take
        conv = accepted & (dx_norm < eps)
        x, chi2, mu, nu = tx, tchi2, tmu, tnu
        it = it + (~stop).to(torch.int32)
        converged = converged | (~stop & conv)
        stop = stop | ~accepted | conv
    return x, SolveStats(chi2, it, converged)
