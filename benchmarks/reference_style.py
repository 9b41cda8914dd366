"""Reference-*formulation* baseline operator, for benchmarking only.

This reimplements (from scratch) the algorithmic shape of the reference's
discrete SSY operator — broadcast the full 8-axis product tensor
``H = A1*A2*A3*Q_lam*Q_c*Q_hz*z_Q`` against ``w^theta`` and sum over the
four next-state axes (reference ``code/ssy/discrete/ssy_wc_ratio.py:
101-148``) — so that ``bench.py`` can report the speedup of the factored
per-axis contraction chain over the formulation the reference uses, on the
same hardware.  O(N^2) work/memory: usable only on small grids (the
reference's 10^4 grid holds H in 800 MB of float64).

A log-space variant applies the identical broadcast-and-reduce to
``exp(theta*ell - max)``, so it can be compared with the log-space
operators; ``space="w"`` is the reference's own w^theta form.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sdfs_via_autodiff_tpu.models.ssy import SSY
from sdfs_via_autodiff_tpu.operators.discrete_ssy import SSYDiscretization


def T_ssy_reference_style(model: SSY, disc: SSYDiscretization,
                          space: str = "log", jit: bool = True):
    theta, beta, gamma = model.theta, model.beta, model.gamma
    n_l, n_k, n_i, n_j = disc.shapes

    # Current-state axes 0-3, next-state axes 4-7 (reference axis
    # numbering, ssy_wc_ratio.py:103-111).
    A1 = jnp.exp(theta * disc.h_lam_states).reshape(1, 1, 1, 1, n_l, 1, 1, 1)
    A2 = jnp.exp(0.5 * ((1 - gamma) * disc.sigma_c_states) ** 2
                 ).reshape(1, n_k, 1, 1, 1, 1, 1, 1)
    A3 = jnp.exp((1 - gamma) * (model.mu_c + disc.z_states)
                 ).reshape(1, 1, n_i, n_j, 1, 1, 1, 1)
    Ql = disc.h_lam_Q.reshape(n_l, 1, 1, 1, n_l, 1, 1, 1)
    Qc = disc.h_c_Q.reshape(1, n_k, 1, 1, 1, n_k, 1, 1)
    Qi = disc.h_z_Q.reshape(1, 1, n_i, 1, 1, 1, n_i, 1)
    Qz = disc.z_Q.reshape(1, 1, n_i, n_j, 1, 1, 1, n_j)

    H = A1 * A2 * A3 * Ql * Qc * Qi * Qz          # rank-8 broadcast product

    # H is an argument of the jitted function, not a closure constant, so
    # the compiled program does not embed its N^2 entries.
    if space == "w":
        def T(w, H):
            hwt = jnp.sum(w.reshape((1,) * 4 + w.shape) ** theta * H,
                          axis=(4, 5, 6, 7))
            return 1.0 + beta * hwt ** (1.0 / theta)
    else:
        def T(ell, H):
            p = theta * ell
            mx = jnp.max(p)
            v = jnp.exp(p - mx).reshape((1,) * 4 + ell.shape)
            s = jnp.sum(v * H, axis=(4, 5, 6, 7))
            return jnp.log1p(beta * jnp.exp((mx + jnp.log(s)) / theta))

    T = jax.jit(T) if jit else T
    return lambda x: T(x, H)
