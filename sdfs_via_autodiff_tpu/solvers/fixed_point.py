"""Successive approximation and Newton–Kantorovich fixed-point solvers.

Redesign of reference ``code/solvers.py:19-95``: the reference
drives the iteration from a host ``while`` loop, paying a dispatch plus a
device->host error readback every iteration (reference ``solvers.py:34-40``).
Here the entire solve — operator applications, sup-norm error, iteration
control, and for Newton the inner matrix-free Krylov solve — is a single
jitted ``lax.while_loop`` that stays resident on the device.  Compiled loops
are cached per operator (see ``_cache``), with tolerance and iteration cap
as traced arguments, so repeated solves never re-compile.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ._cache import cached_build
from .result import SolveResult

DEFAULT_TOL = 1e-7          # reference code/solvers.py:16
DEFAULT_MAX_ITER = 1_000_000  # reference code/solvers.py:17

__all__ = ["successive_approx", "newton_solver", "DEFAULT_TOL",
           "DEFAULT_MAX_ITER"]


STALL_ITERS = 200     # consecutive non-improving iterations before giving up
STALL_RTOL = 1e-5     # relative residual decrease that counts as progress


def _where_tree(pred, a, b):
    """jnp.where over a pytree iterate (fields here are plain arrays,
    but keep the general form)."""
    return jax.tree_util.tree_map(
        lambda u, v: jnp.where(pred, u, v), a, b)


def _iterate(step: Callable, x0, tol, max_iter, *, verbose=False,
             trace_len: int = 0, stall_iters: int = STALL_ITERS,
             final_residual: Optional[Callable] = None) -> SolveResult:
    """Run ``x <- step(x)`` until sup-norm convergence, on device.

    The loop also stops on a NaN residual (divergence guard; the reference
    checks NaNs only manually in notebooks, ``ssy_test_continuous.md:178``)
    and on a residual *plateau*: ``stall_iters`` consecutive iterations
    without a relative improvement of at least ``STALL_RTOL`` over the best
    residual seen.  The plateau guard is what makes an unreachable ``tol``
    safe: a float32 iteration limit-cycles just above its rounding floor,
    and without the guard the loop would spin for the full ``max_iter``
    (reference default 10^6) as one long device while_loop.  The
    slowest legitimate contractions here improve ~1e-3 per iteration
    (rate ~ beta = 0.999), three orders above STALL_RTOL, so the guard
    cannot fire on a healthy solve.  ``tol`` and ``max_iter`` may be
    traced values.
    """
    dtype = jnp.result_type(x0)
    big = jnp.asarray(jnp.inf, dtype=dtype)
    trace0 = jnp.full((trace_len,), jnp.nan, dtype=dtype) if trace_len else None

    def cond(state):
        _, err, it, _, _, since, alive = state
        return ((err > tol) & (it < max_iter) & alive
                & (since < stall_iters))

    def body(state):
        x, err, it, trace, best, since, alive = state
        x_new = step(x)
        err_new = jnp.max(jnp.abs(x_new - x))
        # Divergence guard: on a NON-FINITE step (NaN *or* inf — an
        # f32-envelope exit first shows as inf, e.g. the 18.9M pair
        # case's SA run), stop and KEEP the pre-step iterate and its
        # last finite error, so callers get the last healthy point
        # instead of a poisoned field (the Anderson best-finite-iterate
        # convention).  `err` stays the previous step's value, which by
        # construction was finite (or `big` at it=0).
        ok = jnp.isfinite(err_new)
        if verbose:
            jax.debug.print(
                "iter = {it}, error = {err}", it=it, err=err_new,
                ordered=False)
        if trace is not None:
            trace = trace.at[jnp.minimum(it, trace_len - 1)].set(err_new)
        improved = err_new < best * (1.0 - STALL_RTOL)
        since = jnp.where(ok & improved, 0, since + 1)
        best = jnp.where(ok, jnp.minimum(best, err_new), best)
        return (_where_tree(ok, x_new, x), jnp.where(ok, err_new, err),
                it + 1, trace, best, since, ok)

    x, err, it, trace, _, _, _ = lax.while_loop(
        cond, body, (x0, big, 0, trace0, big, 0, jnp.asarray(True)))
    if final_residual is not None:
        # The loop's error is the STEP size |step(x) - x|.  For plain
        # successive approximation that equals the operator residual by
        # construction, but for composite steps (Newton) a degenerate
        # inner solve can return a zero step far from the solution —
        # observed: float32 BiCGStab breakdown at ~10^7 points
        # returned b = 0, the loop saw error 0.0, and "convergence" was
        # reported at an iterate whose true residual was ~1e-2.  Verify
        # and report the actual fixed-point residual instead.
        err = final_residual(x)
    converged = (err <= tol) & ~jnp.isnan(err)
    return SolveResult(x=x, iterations=it, residual=err, converged=converged,
                       error_trace=trace)


def _run(step: Callable, cache_anchor: Callable, cache_key, x0, tol, max_iter,
         *, verbose, trace_len, jit, stall_iters=STALL_ITERS,
         final_residual=None) -> SolveResult:
    if not jit:
        return _iterate(step, x0, tol, max_iter, verbose=verbose,
                        trace_len=trace_len, stall_iters=stall_iters,
                        final_residual=final_residual)
    fn = cached_build(
        cache_anchor, cache_key,
        lambda: jax.jit(lambda x, t, mi: _iterate(
            step, x, t, mi, verbose=verbose, trace_len=trace_len,
            stall_iters=stall_iters, final_residual=final_residual)))
    return fn(x0, jnp.asarray(tol, jnp.result_type(x0)),
              jnp.asarray(max_iter, jnp.int64))


def successive_approx(T: Callable,
                      x0,
                      tol: float = DEFAULT_TOL,
                      max_iter: int = DEFAULT_MAX_ITER,
                      *,
                      verbose: bool = False,
                      trace_len: int = 0,
                      stall_iters: int = STALL_ITERS,
                      jit: bool = True) -> SolveResult:
    """Successive approximation x <- T(x) to a sup-norm fixed point.

    Parity target: reference ``successive_approx`` (``code/solvers.py:
    19-48``), minus the per-iteration host round-trip; plus the residual
    plateau guard (see ``_iterate``).
    """
    return _run(T, T, ("sa", verbose, trace_len, stall_iters), x0, tol,
                max_iter, verbose=verbose, trace_len=trace_len, jit=jit,
                stall_iters=stall_iters)


def newton_solver(T: Callable,
                  x0,
                  tol: float = DEFAULT_TOL,
                  max_iter: int = DEFAULT_MAX_ITER,
                  *,
                  inner: str = "bicgstab",
                  inner_tol: float = 1e-4,
                  inner_maxiter: Optional[int] = 50,
                  safeguard: bool = True,
                  tangent_T: Optional[Callable] = None,
                  verbose: bool = False,
                  trace_len: int = 0,
                  stall_iters: int = 30,
                  jit: bool = True) -> SolveResult:
    """Newton–Kantorovich iteration for a fixed point of T.

    Defines ``g(x) = T(x) - x`` and iterates the Newton map
    ``q(x) = x - J(x)^{-1} g(x)`` to convergence, exactly the structure of
    reference ``newton_solver`` (``code/solvers.py:51-95``): the Jacobian is
    never materialized — ``jax.jvp`` provides the linear map ``v -> J(x) v``
    (reference ``solvers.py:87``) fed to a matrix-free Krylov solver.

    inner: "bicgstab" (reference default, ``solvers.py:91`` — here the
    mixed-precision implementation of ``solvers/krylov.py``: vectors and
    matvecs in the iterate dtype, recurrence scalars and dot products in
    float64, which survives the 10^7-point f32 grids where vector-dtype
    BiCGStab breaks down to a zero step), "gmres" (jax.scipy), or
    "dense" (explicit ``jacfwd`` + LU solve; small grids only — the
    reference measured the dense path to be slower, ``temp_ssy.py:198-226``; ``inner_tol``/``inner_maxiter`` are
    Krylov-only and do not apply there).

    Unlike the reference's fixed ``atol=1e-4`` (``solvers.py:55``) the inner
    Krylov tolerance here is *relative* to ||g(x)|| (an inexact-Newton
    forcing term): with an absolute tolerance, any iterate with
    ||g(x)|| < atol makes the zero vector an acceptable Krylov solution, the
    Newton step collapses to zero, and the outer loop reports convergence at
    a spurious point.

    ``inner_maxiter`` defaults to 50 (well above the ~10-30 Krylov steps
    these operators need) rather than jax.scipy's default of ``10 * N``:
    at multi-million-point grids that default lowers to a ~10^8-trip
    device while_loop.  Pass ``inner_maxiter=None`` explicitly to restore
    the unbounded behavior.

    ``tangent_T`` (mixed-precision iterative refinement): an optional
    FAST low-precision twin of ``T`` (e.g. the same operator built in
    float32) whose linearization supplies the inner Krylov matvecs, while
    the residual ``g(x) = T(x) - x`` — and the safeguard — stay on ``T``.
    On an f64 operator every inner matvec otherwise costs a full
    f64-precision chain application; with the f32 tangent the correction
    solve runs at fast-tier speed and the refinement still converges to
    ``T``'s own precision, contracting per outer step by roughly the
    f32 solve's relative error (~1e-4) — 2-3 steps from an f32 warm
    start to 1e-12.  Requires ``tangent_T`` to act on float32 arrays of
    the same shape as ``x0``.

    ``safeguard=True`` (default) globalizes the iteration: a Newton
    candidate whose residual is non-finite is rejected in favour of a plain
    fixed-point step T(x) (free — g(x) is already computed).  Newton is not
    globally convergent on these operators (a far-from-solution step can
    leave the domain, e.g. negative w where w^theta is undefined); the
    fallback keeps the iteration inside the contraction's basin.  With
    ``safeguard=False`` a non-finite candidate poisons the iterate so the
    outer NaN guard stops with ``converged=False`` rather than letting
    Krylov silently stall at a zero step and fake convergence.
    """
    g = lambda x: T(x) - x

    if inner == "dense":
        # inner_tol / inner_maxiter are Krylov knobs and do not apply to
        # the direct solve; the safeguard contract is honoured the same
        # way as on the Krylov path.
        def q(x):
            flat = x.reshape(-1)
            shape = x.shape
            gf = lambda v: g(v.reshape(shape)).reshape(-1)
            gx = gf(flat)
            J = jax.jacfwd(gf)(flat)
            x_new = x - jnp.linalg.solve(J, gx).reshape(shape)
            bad = ~jnp.all(jnp.isfinite(gx)) | ~jnp.all(jnp.isfinite(x_new))
            if safeguard:
                g_cand = gf(x_new.reshape(-1))
                grew = (jnp.max(jnp.abs(g_cand))
                        > 10.0 * jnp.max(jnp.abs(gx)))
                bad = bad | ~jnp.all(jnp.isfinite(g_cand)) | grew
                return jnp.where(bad, x + gx.reshape(shape), x_new)
            return jnp.where(bad, jnp.nan, x_new)
    elif inner in ("bicgstab", "gmres"):
        if inner == "bicgstab":
            # Mixed-precision BiCGStab (f32 vectors/matvecs, float64
            # recurrence scalars and reductions — solvers/krylov.py):
            # jax.scipy's vector-dtype scalars break down at ~10^7-point
            # f32 grids (dot-product noise collapses rho/omega, the
            # inner solve returns a zero step).
            from .krylov import bicgstab_mixed

            def krylov(mv, rhs, atol):
                mi = (inner_maxiter if inner_maxiter is not None
                      else 10 * rhs.size)
                return bicgstab_mixed(mv, rhs, atol=atol, maxiter=mi)
        else:
            def krylov(mv, rhs, atol):
                kw = {} if inner_maxiter is None else {
                    "maxiter": inner_maxiter}
                return jax.scipy.sparse.linalg.gmres(mv, rhs, atol=atol,
                                                     **kw)

        def q(x):
            # linearize, not per-matvec jvp: the reference re-runs the
            # primal inside every Krylov matvec (``jax.jvp(g, (x,), (v,))``,
            # reference solvers.py:87); linearize evaluates the primal
            # chain once per Newton step and stores its intermediates as
            # residuals, so each matvec is the pure tangent-linear chain.
            if tangent_T is None:
                gx, jac_prod = jax.linearize(g, x)
                rhs = gx
            else:
                # Iterative refinement: f64 residual, f32 correction
                # solve through the fast twin's tangent (see docstring).
                gx = g(x)
                xt = x.astype(jnp.float32)
                _, jac_prod = jax.linearize(
                    lambda y: tangent_T(y) - y, xt)
                rhs = gx.astype(jnp.float32)
            atol = inner_tol * jnp.linalg.norm(rhs.reshape(-1))
            b, _ = krylov(jac_prod, rhs, atol)
            x_new = x - b.astype(x.dtype)
            # Non-finite residuals silently stall Krylov at a zero step
            # (NaN > atol is False), which would report convergence at a
            # spurious point.
            bad = ~jnp.all(jnp.isfinite(gx)) | ~jnp.all(jnp.isfinite(x_new))
            if safeguard:
                # Reject candidates that are non-finite OR blow the
                # residual up by >10x (low-precision Krylov can emit
                # finite-but-garbage steps far from the solution); fall
                # back to a plain fixed-point step T(x) = x + g(x).
                g_cand = g(x_new)
                grew = (jnp.max(jnp.abs(g_cand))
                        > 10.0 * jnp.max(jnp.abs(gx)))
                bad = bad | ~jnp.all(jnp.isfinite(g_cand)) | grew
                return jnp.where(bad, x + gx, x_new)
            return jnp.where(bad, jnp.nan, x_new)
    else:
        raise ValueError(f"unknown inner solver {inner!r}")

    key = ("newton", inner, inner_tol, inner_maxiter, safeguard, verbose,
           trace_len, stall_iters, tangent_T)
    return _run(q, T, key, x0, tol, max_iter, verbose=verbose,
                trace_len=trace_len, jit=jit, stall_iters=stall_iters,
                final_residual=lambda x: jnp.max(jnp.abs(g(x))))
