"""Implicit differentiation through the fixed point (calibration gradients).

``w*(p)`` solves ``w = T(p, w)``.  The implicit function theorem gives its
parameter sensitivity without differentiating a single solver iteration:

    forward  (I - A) dw           = (dT/dp) dp,        A = dT/dw at w*,
    reverse  (I - A)^T u          = g_bar,   p_bar = (dT/dp)^T u,

each one *matrix-free linear solve* with the same BiCGStab machinery as a
Newton-Kantorovich step (:mod:`.krylov`) — the matvec is a JVP (forward) or
VJP (reverse) of the operator at the solved point.  ``jax.grad`` of any
scalar functional of ``w*`` (a simulated moment, a price, a calibration
loss) therefore costs one fixed-point solve plus one adjoint Krylov solve,
independent of how many thousand iterations the solver ran.

This is capability the reference does not have: its solvers return the
bare fixed point (``/root/reference/code/solvers.py:154-177``) and any
parameter gradient would have to unroll the whole iteration history
through autodiff (unusable at beta ~ 1 iteration counts, and impossible
through its host-side ``while`` loops).  The adjoint solve is the same
sharded contraction chain as the Newton inner loop, so calibration
gradients inherit every sharding tier the operators have.

Conventions
-----------
``T_of_p(p, x) -> x'`` is a *parametric* operator: ``p`` is an arbitrary
pytree (dict of scalars, packed array, ...), traced end to end — both the
operator-construction arrays and the application must be ``jnp``
(the factored quadrature chains are; see ``drivers.wc_ratio_sweep``).
``x0`` and the solver configuration are nondifferentiable data.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .api import solve
from .krylov import bicgstab_mixed

__all__ = ["implicit_fixed_point", "implicit_sensitivity"]


def _adjoint_atol(b, rtol):
    nb = jnp.sqrt(jnp.sum(b.astype(jnp.float64) ** 2))
    return rtol * nb


def _check_krylov_residual(matvec, x, b, atol, label):
    """Surface a stagnated Krylov solve instead of silently returning a
    wrong gradient: with beta ~ 1 the system (I - A) is nearly singular
    and BiCGStab can exhaust maxiter far from tolerance.  One extra
    matvec; warns (traced-safe) when the true residual exceeds 10x the
    target."""
    r = b - matvec(x)
    rn = jnp.sqrt(jnp.sum(r.astype(jnp.float64) ** 2))
    bad = rn > 10.0 * jnp.maximum(atol, jnp.asarray(1e-300))

    def _warn(_):
        jax.debug.print(
            "implicit {l} Krylov solve stagnated: |residual|={r:.3e} > "
            "10x atol={a:.3e}; gradients may be inaccurate (raise "
            "adjoint_maxiter or relax adjoint_rtol)", l=label, r=rn,
            a=atol)

    jax.lax.cond(bad, _warn, lambda _: None, operand=None)
    return x


def implicit_fixed_point(T_of_p: Callable, p, x0, *,
                         method: str = "newton",
                         tol: float = 1e-7,
                         adjoint_rtol: float = 1e-8,
                         adjoint_maxiter: int = 200,
                         **solve_kwargs):
    """Solve ``x = T_of_p(p, x)`` and return ``x*`` as a *differentiable*
    function of ``p`` (reverse mode, via :func:`jax.custom_vjp`).

    The forward pass runs the ordinary nondifferentiable solver
    (:func:`solvers.solve` with ``method``/``tol``/``solve_kwargs``); the
    backward pass solves the adjoint equation ``(I - A)^T u = g_bar``
    matrix-free with :func:`bicgstab_mixed` (``adjoint_rtol`` relative to
    ``||g_bar||_2``, ``adjoint_maxiter`` iterations) and returns
    ``p_bar = (dT/dp)^T u``.

    The gradient error is O(solver residual) + O(adjoint residual); with
    the default 1e-7 sup-norm solve and 1e-8 adjoint rtol, f64 gradients
    agree with central finite differences to ~1e-6 relative (tests).

    Notes: ``x0`` receives no cotangent (at the fixed point the solution
    does not depend on the start); grids/quadrature baked into ``T_of_p``
    as non-``p`` closures are held fixed, i.e. sensitivities are of the
    collocation *values*, the standard IFT convention.
    """

    @jax.custom_vjp
    def _solve(q):
        res = solve(lambda x: T_of_p(q, x), x0, method=method, tol=tol,
                    **solve_kwargs)
        return res.x

    def _fwd(q):
        x_star = _solve(q)
        return x_star, (q, x_star)

    def _bwd(saved, ct):
        q, x_star = saved
        _, vjp_x = jax.vjp(lambda x: T_of_p(q, x), x_star)
        matvec = lambda u: u - vjp_x(u)[0]
        atol = _adjoint_atol(ct, adjoint_rtol)
        u, _ = bicgstab_mixed(matvec, ct, atol=atol,
                              maxiter=adjoint_maxiter)
        u = _check_krylov_residual(matvec, u, ct, atol, "adjoint")
        _, vjp_p = jax.vjp(lambda r: T_of_p(r, x_star), q)
        return (vjp_p(u)[0],)

    _solve.defvjp(_fwd, _bwd)
    return _solve(p)


def implicit_sensitivity(T_of_p: Callable, p, dp, x_star, *,
                         rtol: float = 1e-8,
                         maxiter: int = 200):
    """Directional (forward-mode) sensitivity ``dx = (dw*/dp) dp`` at an
    already-solved fixed point ``x_star``.

    Solves ``(I - A) dx = (dT/dp) dp`` matrix-free; the matvec is a JVP of
    the operator in ``x`` — one Krylov solve per direction, so this is the
    cheap path when you want a handful of named-parameter sensitivities
    rather than the gradient of a scalar loss.
    """
    b = jax.jvp(lambda q: T_of_p(q, x_star), (p,), (dp,))[1]
    matvec = lambda v: v - jax.jvp(lambda x: T_of_p(p, x), (x_star,), (v,))[1]
    atol = _adjoint_atol(b, rtol)
    dx, _ = bicgstab_mixed(matvec, b, atol=atol, maxiter=maxiter)
    return _check_krylov_residual(matvec, dx, b, atol, "tangent")
