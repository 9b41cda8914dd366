"""Anderson acceleration, implemented natively (no jaxopt dependency).

The reference wraps ``jaxopt.AndersonAcceleration`` with hard-coded
hyperparameters (reference ``code/solvers.py:98-124``: mixing_frequency=4,
history_size=10, beta=8.0, ridge=1e-6, jit+unroll).  jaxopt is unmaintained
and absent from this environment, so this is a from-scratch Type-II AA:

* residual/iterate histories live in fixed-size ring buffers on device;
* the constrained least-squares  min ||sum_i a_i g_i||, sum a_i = 1  is
  solved via ridge-regularized normal equations (an m x m solve, m ~ 10 —
  trivially cheap relative to an operator application);
* ``beta`` is the relaxation weight: x+ = (1-beta)*sum a_i x_i
  + beta*sum a_i f_i (beta > 1 over-relaxes, as the reference's beta=8);
* ``mixing_frequency`` applies the AA combination only every k-th
  iteration, with plain fixed-point steps in between.

The whole loop is one jitted ``lax.while_loop``; histories never leave the
device, which also makes the solver work unchanged on sharded iterates
(the m x m normal matrix is formed by reductions XLA turns into psums).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from ._cache import cached_build
from .fixed_point import DEFAULT_TOL
from .result import SolveResult

__all__ = ["anderson_solver"]


def _solve_small_spd(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b for a small SPD matrix by unrolled Gauss–Jordan.

    The ridge-regularized Gram system here is tiny (history_size ~ 10) and
    positive definite, so plain elimination with diagonal pivots in basic
    arithmetic is both portable and stable enough, and needs no LU
    decomposition.
    """
    m = A.shape[0]
    M = jnp.concatenate([A, b[:, None]], axis=1)
    for i in range(m):
        M = M / jnp.where(jnp.arange(m) == i, M[i, i], 1.0)[:, None]
        row = M[i]
        elim = jnp.where(jnp.arange(m)[:, None] == i, 0.0, M[:, i:i + 1])
        M = M - elim * row[None, :]
    return M[:, m]


def anderson_solver(T: Callable,
                    x0,
                    tol: float = DEFAULT_TOL,
                    max_iter: int = 10_000,
                    *,
                    history_size: int = 10,
                    mixing_frequency: int = 4,
                    beta: float = 8.0,
                    ridge: float = 1e-6,
                    warmup: int = 10,
                    verbose: bool = False,
                    jit: bool = True) -> SolveResult:
    """Anderson-accelerated fixed point of T.

    Defaults mirror the reference configuration (``code/solvers.py:104-113``)
    plus its notebook practice of warm-starting with plain T iterations
    (reference ``ssy_test_continuous.md:171-175``).
    """
    m = history_size
    shape = x0.shape
    dtype = jnp.result_type(x0)

    # The Gram matrix squares the residual magnitudes; in a float32 solve
    # the normal equations lose all signal once residuals shrink below
    # ~sqrt(eps).  Accumulate the m x m system in float64 (tiny cost: m^2
    # dot products) and solve there.
    gram_dtype = jnp.float64 if dtype == jnp.float32 else dtype

    # Histories keep the iterate's full grid shape ((m,) + shape, not
    # (m, n)): a flatten would destroy a multi-axis NamedSharding and
    # re-lay-out / all-gather the iterate every iteration at scale — the
    # Gram and the combinations are shaped reductions GSPMD partitions
    # in place (local partials + psum).
    def aa_combination(X, F, fx):
        """Solve the ridge normal equations over the m stored pairs."""
        G = F - X                                   # residuals, (m,)+shape
        # Pairwise Gram over the upper triangle: m(m+1)/2 dots, each
        # keeping one vector pair live at a time.  Whether one batched
        # (m,)+shape einsum is faster on the GPU is not measured yet
        # (ROADMAP Speed item 2).
        rows = [[None] * m for _ in range(m)]
        for i in range(m):
            gi = G[i].astype(gram_dtype)
            for j in range(i, m):
                rows[i][j] = rows[j][i] = jnp.sum(
                    gi * G[j].astype(gram_dtype))
        A = jnp.stack([jnp.stack(r) for r in rows])  # (m, m) Gram
        scale = jnp.maximum(jnp.trace(A) / m, 1e-30)
        A = A + ridge * scale * jnp.eye(m, dtype=gram_dtype)
        ones = jnp.ones((m,), dtype=gram_dtype)
        c = _solve_small_spd(A, ones)
        alpha = (c / jnp.sum(c)).astype(dtype)
        x_plus = ((1.0 - beta) * jnp.tensordot(alpha, X, axes=1)
                  + beta * jnp.tensordot(alpha, F, axes=1))
        # Guard: fall back to a plain step if the solve went non-finite.
        bad = ~jnp.all(jnp.isfinite(x_plus))
        return jnp.where(bad, fx, x_plus)

    def run(x_init, tol, max_iter):
        X0 = jnp.zeros((m,) + shape, dtype=dtype)
        F0 = jnp.zeros((m,) + shape, dtype=dtype)
        big = jnp.asarray(jnp.inf, dtype=dtype)
        # Residual plateau guard (see fixed_point._iterate): AA residuals
        # oscillate, so the window is generous — it exists to stop f32
        # limit cycles from spinning to max_iter, not to police progress.
        stall_iters, stall_rtol = 500, 1e-5

        def body(state):
            x, x_best, X, F, err, it, best, since = state
            fx = T(x)
            err = jnp.max(jnp.abs(fx - x))
            # Best-iterate carry: an AA combination can leave the f32
            # operator's envelope (T(x_plus) -> NaN poisons the next
            # iterate); keeping the lowest-residual point lets a failed
            # run return usable partial progress instead of NaN.
            x_best = jnp.where(err < best, x, x_best)
            if verbose:
                jax.debug.print("iter = {it}, error = {err}", it=it, err=err,
                                ordered=False)
            slot = it % m
            X = X.at[slot].set(x)
            F = F.at[slot].set(fx)
            use_aa = (it >= warmup) & (it >= m) & (it % mixing_frequency == 0)
            x_next = lax.cond(use_aa,
                              lambda: aa_combination(X, F, fx),
                              lambda: fx)
            improved = err < best * (1.0 - stall_rtol)
            since = jnp.where(improved, 0, since + 1)
            # jnp.minimum propagates NaN; a poisoned final error must
            # not destroy the best-residual record.
            best = jnp.minimum(best, jnp.where(jnp.isnan(err), big, err))
            return x_next, x_best, X, F, err, it + 1, best, since

        def cond_(state):
            _, _, _, _, err, it, _, since = state
            return ((err > tol) & (it < max_iter) & ~jnp.isnan(err)
                    & (since < stall_iters))

        x, x_best, _, _, err, it, best, _ = lax.while_loop(
            cond_, body, (x_init, x_init, X0, F0, big, 0, big, 0))
        # A NaN stop returns the best finite iterate rather than the
        # poisoned point.
        x = jnp.where(jnp.isnan(err), x_best, x)
        # The loop's carried x is one step AHEAD of the residual it
        # stopped on (possibly an AA extrapolation that was never
        # residual-checked).  Verify the point actually returned — one
        # extra T application — and fall back to the best recorded
        # iterate when the candidate is worse or non-finite, so
        # ``residual`` always belongs to ``x`` and ``converged`` is a
        # statement about the returned point (same contract as
        # newton_solver's final_residual).
        fr = jnp.max(jnp.abs(T(x) - x))
        use_best = jnp.isnan(fr) | (fr > best)
        x = jnp.where(use_best, x_best, x)
        err = jnp.where(use_best, best, fr)
        converged = (err <= tol) & ~jnp.isnan(err)
        return SolveResult(x=x, iterations=it, residual=err,
                           converged=converged)

    if not jit:
        return run(x0, tol, max_iter)
    key = ("anderson", m, mixing_frequency, beta, ridge, warmup, verbose,
           x0.shape, str(dtype))
    fn = cached_build(T, key, lambda: jax.jit(run))
    return fn(x0, jnp.asarray(tol, dtype), jnp.asarray(max_iter, jnp.int64))
