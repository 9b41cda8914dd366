"""Matrix-free Krylov inner solvers with mixed-precision reductions.

The Newton–Kantorovich inner solve is a matrix-free Krylov iteration on
the device iterate (float32 on the fast tier).  ``jax.scipy``'s
BiCGStab runs its *recurrence scalars* (rho = <r_hat, r>, alpha, omega)
in the vector dtype; at 10^7-point grids a float32 dot product carries
O(sqrt(N) * eps) ~ 1e-4 relative noise, and BiCGStab's scalar ratios
amplify it until rho/omega collapse — the observed f32 "breakdown at
scale" that returned a zero step on a 25M-point GCY grid and forced
that case onto Anderson acceleration.

This BiCGStab keeps every VECTOR in the iterate dtype (f32 matvecs, f32
state — the expensive part, and all the device memory) but computes
every REDUCTION and recurrence scalar in float64: the per-iteration cost
is two f64 tree-reductions against two full operator matvecs —
noise-floor arithmetic for free.

The loop is one ``lax.while_loop`` (device-resident, bounded — see the
``newton_solver`` docstring for why inner loops are bounded) with explicit breakdown guards: |rho| or |<r_hat, v>|
or <t, t> underflowing stops the iteration and returns the current
iterate, whose quality the caller (Newton's safeguard + true-residual
reporting, ``fixed_point.py``) already polices.

Reference counterpart: the reference feeds ``jax.scipy``'s BiCGStab with
per-matvec ``jax.jvp`` at default (vector-dtype) precision
(``/root/reference/code/solvers.py:87-91``); it never runs past ~10^5
points where f32 reduction noise is invisible.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax.numpy as jnp
from jax import lax

__all__ = ["bicgstab_mixed"]


def _dot64(a, b):
    """<a, b> accumulated in float64."""
    return jnp.sum(a.astype(jnp.float64) * b.astype(jnp.float64))


def bicgstab_mixed(matvec: Callable, b, *, atol=0.0,
                   maxiter: Optional[int] = 50,
                   x0=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Solve ``A x = b`` (A = ``matvec``) by BiCGStab with float64
    recurrence scalars over iterate-dtype vectors.

    Same call shape as ``jax.scipy.sparse.linalg.bicgstab``: returns
    ``(x, info)`` where ``info`` is the number of iterations run (int32;
    diagnostic only, like scipy's).  ``atol`` is the absolute target on
    ||b - A x||_2, evaluated on the recursive residual.  ``maxiter``
    bounds the device loop (None is rejected — pass an explicit large
    bound if you really want one).
    """
    if maxiter is None:
        raise ValueError("bicgstab_mixed requires an explicit maxiter; "
                         "jax.scipy.sparse.linalg.bicgstab accepts None "
                         "if you must")
    vdtype = jnp.result_type(b)
    shape = b.shape
    flat = lambda v: v.reshape(-1)
    down = lambda s: s.astype(vdtype)

    bf = flat(b)
    if x0 is None:
        x = jnp.zeros_like(bf)
        r = bf
    else:
        x = flat(jnp.asarray(x0, vdtype))
        r = bf - flat(matvec(x0))
    r_hat = r                                  # shadow residual (fixed)
    f64 = jnp.float64
    one = jnp.asarray(1.0, f64)
    atol2 = jnp.asarray(atol, f64) ** 2
    # Breakdown floors, relative to the initial residual scale: scalar
    # ratios whose denominators fall this far below rnorm0^2 carry no
    # information at ~47-bit precision.
    rho0 = _dot64(r, r)
    tiny = jnp.maximum(rho0, jnp.asarray(1.0, f64)) * 1e-28

    def cond(state):
        _, r, _, _, rho, alpha, omega, it, ok = state
        rnorm2 = _dot64(r, r)
        return (rnorm2 > atol2) & (it < maxiter) & ok & jnp.isfinite(rnorm2)

    def body(state):
        x, r, p, v, rho, alpha, omega, it, ok = state
        rho_new = _dot64(r_hat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p_new = r + down(beta) * (p - down(omega) * v)
        v_new = flat(matvec(p_new.reshape(shape)))
        rv = _dot64(r_hat, v_new)
        alpha_new = rho_new / rv
        s = r - down(alpha_new) * v_new
        x_half = x + down(alpha_new) * p_new
        t = flat(matvec(s.reshape(shape)))
        tt = _dot64(t, t)
        omega_new = _dot64(t, s) / tt
        x_full = x_half + down(omega_new) * s
        r_full = s - down(omega_new) * t
        # Three-way outcome, in priority order:
        # (1) the alpha scalars are degenerate -> freeze at the pre-step
        #     state and stop (applying them would poison the iterate);
        # (2) the half step already converged (||s|| <= atol — exact on
        #     diagonal-like systems, where t = 0 makes omega 0/0), or
        #     the omega scalars are degenerate -> take the half step,
        #     whose residual s is well-defined, and stop;
        # (3) healthy -> full BiCGStab update.
        bad_a = ((jnp.abs(rho_new) <= tiny) | (jnp.abs(rv) <= tiny)
                 | ~jnp.isfinite(beta) | ~jnp.isfinite(alpha_new))
        half = ((_dot64(s, s) <= atol2) | (tt <= tiny)
                | ~jnp.isfinite(omega_new))
        pick = lambda full_, half_, old: jnp.where(
            bad_a, old, jnp.where(half, half_, full_))
        return (pick(x_full, x_half, x), pick(r_full, s, r),
                pick(p_new, p_new, p), pick(v_new, v_new, v),
                pick(rho_new, rho_new, rho),
                pick(alpha_new, alpha_new, alpha),
                pick(omega_new, omega, omega),
                it + 1, ~(bad_a | half))

    z = jnp.zeros_like(bf)
    x, r, *_, it, _ = lax.while_loop(
        cond, body, (x, r, z, z, one, one, one, jnp.asarray(0, jnp.int32),
                     jnp.asarray(True)))
    return x.reshape(shape), it
