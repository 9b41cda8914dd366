"""Shared machinery for the continuous-state Koopmans operators.

The reference evaluates the continuous operator pointwise: for every grid
state x it forms all quadrature/MC successor states, gathers a multilinear
interpolation of w at each, and reduces (reference
``code/ssy/continuous_junnan/ssy_wc_ratio_continuous.py:90-153``).  That is
a bandwidth-bound 2^d-corner gather per (state, node) pair.

The alternative implemented here (``expectation_matrix``): when the
power is applied *before* interpolation (interpolating g = w^theta, the
"pre" interpolation space), the interpolant is linear in the grid values,

    interp(g)(x') = sum_k g[k] * prod_d b_{k_d}(x'_d),

and because each state dimension's successor x'_d is driven by its own
independent N(0,1) shock, the tensor-product quadrature expectation
factorizes into per-dimension *expectation matrices*

    P_d[i, k] = sum_q omega_q * b_k( mu_d(x_i) + sigma_d * eta_q ),

so E_x[interp(g)(x')] is a chain of per-axis contractions of g against the
P_d — identical in structure (and kernel cost) to the discrete operator,
with matmuls instead of gathers.  The factorization is *exact*
for the tensor-product Gauss-Hermite rule: both paths are offered and
cross-checked in the tests.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp

from ..ops.grids import flatten_mesh
from ..ops.interp import lin_interp

__all__ = ["hat_basis", "expectation_matrix", "make_gather_T",
           "warn_if_f32_range_unsafe", "normalize_expectation_matrix",
           "additive_profiles"]


def additive_profiles(ell_field):
    """Fit an additive (ANOVA main-effects) model to a log-solution field.

    Returns ``(const, [profile_0, ..., profile_{d-1}])`` with
    ell ~ const + sum_d profile_d[i_d]; the profiles are mean-centered
    axis averages.  Fitted on a coarse float64 solve, these are the ideal
    separable baselines for normalizing the continuous operators: unlike
    the log-linear closed form (a local approximation around the mean,
    measured up to ~4.4 log units off at grid corners for GCY), the
    residual is just the solution's interaction structure, typically well
    inside float32's exponential range.
    """
    import numpy as np

    ell = np.asarray(ell_field, np.float64)
    const = float(ell.mean())
    profiles = []
    for d in range(ell.ndim):
        axes = tuple(a for a in range(ell.ndim) if a != d)
        profiles.append(ell.mean(axis=axes) - const)
    return const, profiles


def normalize_expectation_matrix(P, phi_next, phi_cur, theta):
    """Fold a separable baseline component into an expectation matrix.

    Returns P~[..., x, y] = P[..., x, y] * exp(theta*(phi_next[y] -
    phi_cur[..., x])), assembled in host float64 (full exponent range) so
    the result is f32-castable wherever it is representable; entries whose
    true magnitude underflows f32 go to zero (negligible by construction).
    Continuous grids are plain tensor products, so unlike the discrete
    Rouwenhorst case every baseline component is a 1-D per-axis profile
    and the telescoping is trivial.
    """
    import numpy as np

    P64 = np.asarray(P, np.float64)
    with np.errstate(divide="ignore"):
        logP = np.log(P64)
    nxt = np.asarray(phi_next, np.float64)
    cur = np.asarray(phi_cur, np.float64)
    return np.exp(logP + theta * (nxt - cur[..., None]))


def warn_if_f32_range_unsafe(model, grids, loglinear_factory, dtype) -> None:
    """Warn when theta * (log-linear w range over the grid) exceeds what
    float32 exponentials can represent (~80): the log-space operator will
    overflow at such state-space spans (the GCY continuous z grid spans
    stationary scale via its 1/(1-rho) factor, unlike SSY's).  Baseline
    normalization of the continuous operators is the planned fix."""
    import warnings

    import numpy as np

    from ..ops.grids import flatten_mesh

    if dtype != jnp.float32:
        return
    try:
        ll = loglinear_factory(model)
        vals = ll(np.asarray(flatten_mesh(grids)).T)
        span = abs(model.theta) * float(np.max(vals) - np.min(vals))
    except Exception:
        return
    if span > 80.0:
        warnings.warn(
            f"theta * log-w range over this grid is ~{span:.0f}, beyond "
            "float32's exponential range (~80): the f32 log-space operator "
            "will overflow at the state-space corners. Use float64 (CPU) "
            "or a smaller num_std_devs.", stacklevel=3)


def hat_basis(grid: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """Multilinear ("hat") basis weights of ``points`` on a uniform grid.

    Returns B with shape ``points.shape + (len(grid),)`` where
    ``B[..., k] = b_k(points)``; each row has at most two non-zeros summing
    to one.  Out-of-range points clamp to the edge (same 'nearest' rule as
    :func:`..ops.interp.multilinear_interp`).
    """
    n = grid.shape[0]
    if n == 1:
        return jnp.ones(points.shape + (1,), dtype=points.dtype)
    step = grid[1] - grid[0]
    c = (points - grid[0]) / step
    i0 = jnp.clip(jnp.floor(c), 0, n - 2).astype(jnp.int32)
    t = jnp.clip(c - i0, 0.0, 1.0)
    k = jnp.arange(n)
    lo = (k == i0[..., None]) * (1.0 - t[..., None])
    hi = (k == (i0 + 1)[..., None]) * t[..., None]
    return lo + hi


def expectation_matrix(grid: jnp.ndarray,
                       mean: jnp.ndarray,
                       scale,
                       nodes: jnp.ndarray,
                       weights: jnp.ndarray,
                       payoff: Optional[Callable] = None) -> jnp.ndarray:
    """Per-dimension expectation matrix for x' = mean + scale * eta.

    ``mean`` has an arbitrary batch shape (conditioning states); ``scale``
    broadcasts against it.  Returns P of shape ``mean.shape + (len(grid),)``
    with

        P[..., k] = sum_q weights[q] * payoff(x'_q) * b_k(x'_q),

    where ``payoff`` (default 1) folds state-dependent factors such as the
    SSY/GCY ``exp(theta * h_lam')`` into the matrix.
    """
    x_next = mean[..., None] + jnp.asarray(scale)[..., None] * nodes  # (..., q)
    B = hat_basis(grid, x_next)                                      # (..., q, k)
    if payoff is not None:
        B = B * payoff(x_next)[..., None]
    return jnp.einsum("q,...qk->...k", weights, B)


def make_gather_T(next_state: Callable,
                  log_kappa: Callable,
                  grids: Sequence[jnp.ndarray],
                  shocks: jnp.ndarray,
                  weights,
                  interp: str,
                  space: str,
                  batch_size,
                  beta: float,
                  theta: float) -> Callable:
    """Pointwise (vmapped gather) continuous operator, model-agnostic.

    ``next_state(x, shocks)``: successor states, shape ``(dim, n_shocks)``,
    with dimension 0 = h_lam (whose successor carries the exp(theta*h')
    payoff in both SSY and GCY).  ``log_kappa(x)``: log of the
    state-dependent constant.  ``weights`` None means equal MC weights.

    interp: "post" (reference semantics — interpolate w, then power),
    "pre" (interpolate w^theta), "loglin" (interpolate log w).
    space: "w" iterates on w; "log" iterates on ell = log w with
    shift-stabilized expectations (required in float32).
    """
    if interp not in ("post", "pre", "loglin"):
        raise ValueError(f"unknown interp {interp!r}")
    dim = len(grids)
    shape = tuple(len(g) for g in grids)
    x_flat = flatten_mesh(grids)
    n = x_flat.shape[0]
    if batch_size is None or batch_size >= n:
        batches = x_flat[None]
    else:
        if n % batch_size:
            raise ValueError(
                f"state-space size {n} not divisible by batch_size {batch_size}")
        batches = x_flat.reshape(n // batch_size, batch_size, dim)

    def reduce_rule(vals):
        return jnp.mean(vals) if weights is None else jnp.dot(vals, weights)

    if space == "w":
        # The field transform (w^theta / log w) happens ONCE in T, not
        # inside the kernel: lax.map does not hoist loop invariants, so
        # an in-kernel transform would recompute the O(N) power per
        # batch step (the log-space branch below has the same shape).
        def kernel(x, field):
            next_x = next_state(x, shocks)
            pf = jnp.exp(theta * next_x[0])
            if interp == "post":
                vals = lin_interp(next_x, field, grids) ** theta
            elif interp == "pre":
                vals = lin_interp(next_x, field, grids)
            else:
                vals = jnp.exp(theta * lin_interp(next_x, field, grids))
            return jnp.exp(log_kappa(x)) * reduce_rule(vals * pf)

        vkernel = jax.vmap(kernel, in_axes=(0, None))

        def T(w):
            field = (w if interp == "post"
                     else w ** theta if interp == "pre" else jnp.log(w))
            kg = jax.lax.map(lambda xb: vkernel(xb, field), batches)
            return 1.0 + beta * kg.reshape(shape) ** (1.0 / theta)
    else:
        def log_expect(a_vals):
            mx = jnp.max(a_vals)
            return mx + jnp.log(reduce_rule(jnp.exp(a_vals - mx)))

        def kernel(x, field):
            next_x = next_state(x, shocks)
            pf = theta * next_x[0]
            if interp == "post":       # field = w = exp(ell)
                return log_expect(
                    theta * jnp.log(lin_interp(next_x, field, grids)) + pf)
            if interp == "loglin":     # field = ell
                return log_expect(
                    theta * lin_interp(next_x, field, grids) + pf)
            # "pre": field = exp(theta*ell - mx_global); caller adds mx back.
            vals = lin_interp(next_x, field, grids) * jnp.exp(pf)
            return jnp.log(reduce_rule(vals))

        vkernel = jax.vmap(kernel, in_axes=(0, None))
        log_kappa_flat = jax.vmap(log_kappa)(x_flat).reshape(shape)

        def T(ell):
            if interp == "pre":
                mx = jnp.max(theta * ell)
                field, shift = jnp.exp(theta * ell - mx), mx
            elif interp == "post":
                field, shift = jnp.exp(ell), 0.0
            else:
                field, shift = ell, 0.0
            log_kg = jax.lax.map(lambda xb: vkernel(xb, field), batches)
            log_kg = log_kg.reshape(shape) + shift + log_kappa_flat
            return jnp.log1p(beta * jnp.exp(log_kg / theta))

    return T
