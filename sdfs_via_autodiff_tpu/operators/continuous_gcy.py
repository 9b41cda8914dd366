"""Continuous-state Koopmans operator for the GCY model.

State grids (h_lam, h_c, h_z, h_zpi, z, z_pi) — the axis order of the
reference continuous layer (``code/gcy/continuous/gcy_wc_ratio_continuous.py:
20-21``, which differs from the discrete layer's order).  Parity targets:
``next_state`` (:77-115), ``Kg_vmap_mc``/``Kg_vmap_quad`` (:122-187),
``T_fun_factory`` (:190-261).

Same three interpolation spaces and the log-space option as the SSY
continuous operator; quadrature + interp="pre" runs as a factored chain of
per-axis contractions with conditional expectation matrices for z
(conditioning on h_z and z_pi) and z_pi (conditioning on h_zpi).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp

from ..models.gcy import GCY
from ..ops.grids import build_grid_gcy
from ..ops.quadrature import gauss_hermite_normal, tensor_quadrature_normal
from .continuous_common import expectation_matrix, make_gather_T

# Keep float32 operands in float32 on the GPU (its default is TF32, which
# keeps about three digits); a no-op for float64.
_HI = jax.lax.Precision.HIGHEST

__all__ = ["next_state_gcy", "T_gcy_continuous_factory", "build_grid_gcy"]


def next_state_gcy(model: GCY, x: jnp.ndarray, shocks: jnp.ndarray) -> jnp.ndarray:
    """One step of the six GCY state processes.

    ``x`` has leading axis (h_lam, h_c, h_z, h_zpi, z, z_pi); ``shocks`` is
    (6, N).  Parity: reference ``next_state``
    (``gcy_wc_ratio_continuous.py:77-115``).
    """
    m = model
    h_lam, h_c, h_z, h_zpi, z, z_pi = (x[i] for i in range(6))
    sigma_z = m.phi_z * jnp.exp(h_z)
    sigma_zpi = m.phi_zpi * jnp.exp(h_zpi)
    return jnp.stack([
        m.rho_lam * h_lam + m.s_lam * shocks[0],
        m.rho_c * h_c + m.s_c * shocks[1],
        m.rho_z * h_z + m.s_z * shocks[2],
        m.rho_zpi * h_zpi + m.s_zpi * shocks[3],
        m.rho * z + m.rho_pi * z_pi + sigma_z * shocks[4],
        m.rho_pipi * z_pi + sigma_zpi * shocks[5],
    ])


def _log_kappa_gcy(model: GCY, h_c, z):
    """log kappa = (1-gamma)(mu_c+z) + (1/2)(1-gamma)^2 sigma_c^2 with
    sigma_c = phi_c*exp(h_c) (reference ``gcy_wc_ratio_continuous.py:
    135-136``)."""
    sigma_c = model.phi_c * jnp.exp(h_c)
    return ((1 - model.gamma) * (model.mu_c + z)
            + 0.5 * (1 - model.gamma) ** 2 * sigma_c ** 2)


def _factored_arrays_gcy(model, grids, degree, baseline=None,
                         tilt_lambda=True) -> dict:
    """Expectation matrices + baseline components of the factored GCY
    operator (quadrature + interp="pre").

    Shared by :func:`_factored_T` and the two-phase operand set
    (``operators/two_phase.two_phase_operands_gcy_continuous``).  Axis
    labels: l=h_lam, k=h_c, i=h_z, y=h_zpi, j=z, b=z_pi; capitals are
    next-period indices.  Returns P_lam (l), P_c (k), P_hz (i), P_hzpi
    (y), the conditioned P_zpi (y, b, B) and P_z (i, j, b, J), the split
    kappa terms log_A2 (k) / log_A3 (j), and — when a baseline is folded
    — the separable components (const0, phi_l..phi_b).
    """
    theta = model.theta
    m = model
    h_lam_grid, h_c_grid, h_z_grid, h_zpi_grid, z_grid, z_pi_grid = grids
    eta, omega = map(jnp.asarray, gauss_hermite_normal(degree))

    P_lam = expectation_matrix(h_lam_grid, m.rho_lam * h_lam_grid, m.s_lam,
                               eta, omega,
                               payoff=(lambda xn: jnp.exp(theta * xn))
                               if tilt_lambda else None)
    P_c = expectation_matrix(h_c_grid, m.rho_c * h_c_grid, m.s_c, eta, omega)
    P_hz = expectation_matrix(h_z_grid, m.rho_z * h_z_grid, m.s_z, eta, omega)
    P_hzpi = expectation_matrix(h_zpi_grid, m.rho_zpi * h_zpi_grid, m.s_zpi,
                                eta, omega)
    sigma_z = m.phi_z * jnp.exp(h_z_grid)          # (i,)
    sigma_zpi = m.phi_zpi * jnp.exp(h_zpi_grid)    # (y,)
    # z_pi' = rho_pipi*z_pi + sigma_zpi(h_zpi)*eta: P_zpi[y, b, B]
    P_zpi = expectation_matrix(
        z_pi_grid,
        jnp.broadcast_to(m.rho_pipi * z_pi_grid,
                         (len(h_zpi_grid), len(z_pi_grid))),
        sigma_zpi[:, None], eta, omega)
    # z' = rho*z + rho_pi*z_pi + sigma_z(h_z)*eta: P_z[i, j, b, J]
    mean_z = (m.rho * z_grid[None, :, None]
              + m.rho_pi * z_pi_grid[None, None, :])
    mean_z = jnp.broadcast_to(mean_z, (len(h_z_grid), len(z_grid),
                                       len(z_pi_grid)))
    P_z = expectation_matrix(z_grid, mean_z, sigma_z[:, None, None],
                             eta, omega)
    # log kappa(h_c, z) splits into a row (h_c) and a column (z) part.
    sigma_c = m.phi_c * jnp.exp(h_c_grid)
    log_A2 = 0.5 * (1 - m.gamma) ** 2 * sigma_c ** 2               # (k,)
    log_A3 = (1 - m.gamma) * (m.mu_c + z_grid)                     # (j,)

    ell0_parts = None
    if baseline is not None:
        # Fold a separable baseline into the expectation matrices (the
        # batched P_z/P_zpi rescale over their last two axes).  Required
        # for f32: theta*(log-w range) ~ 200 on the reference's z-grid
        # bounds.  baseline is "loglinear" or (const, [profiles]) from
        # additive_profiles() on a coarse solve — the latter strongly
        # preferred for GCY (the closed form is ~4 log units off at
        # corners, still beyond f32 after folding).
        import numpy as np
        from .continuous_common import normalize_expectation_matrix
        if baseline == "loglinear":
            from ..models.gcy import gcy_loglinear_factory
            co = gcy_loglinear_factory(m).coefficients
            hl = np.asarray(h_lam_grid, np.float64)
            hc = np.asarray(h_c_grid, np.float64)
            hz = np.asarray(h_z_grid, np.float64)
            hy = np.asarray(h_zpi_grid, np.float64)
            zg = np.asarray(z_grid, np.float64)
            bg = np.asarray(z_pi_grid, np.float64)
            const0 = co["A0"]
            phi_l = co["A_hlam"] * hl
            phi_k = co["A_hc"] * (hc * 2 * m.phi_c**2 + m.phi_c**2)
            phi_i = co["A_hz"] * (hz * 2 * m.phi_z**2 + m.phi_z**2)
            phi_y = co["A_hzpi"] * (hy * 2 * m.phi_zpi**2 + m.phi_zpi**2)
            phi_j = co["A_z"] * zg
            phi_b = co["A_zpi"] * bg
        else:
            const0, profs = baseline
            (phi_l, phi_k, phi_i, phi_y, phi_j, phi_b) = (
                np.asarray(p_, np.float64) for p_ in profs)
        P_lam = jnp.asarray(normalize_expectation_matrix(
            P_lam, phi_l, phi_l, theta))
        P_c = jnp.asarray(normalize_expectation_matrix(
            P_c, phi_k, phi_k, theta))
        P_hz = jnp.asarray(normalize_expectation_matrix(
            P_hz, phi_i, phi_i, theta))
        P_hzpi = jnp.asarray(normalize_expectation_matrix(
            P_hzpi, phi_y, phi_y, theta))
        # P_zpi[y, b, B]: current index is b (axis -2).
        P_zpi = jnp.asarray(normalize_expectation_matrix(
            P_zpi, phi_b, np.broadcast_to(phi_b, P_zpi.shape[:-1]), theta))
        # P_z[i, j, b, J]: current index is j (axis 1 of the batch).
        cur_j = np.broadcast_to(phi_j[None, :, None], P_z.shape[:-1])
        P_z = jnp.asarray(normalize_expectation_matrix(
            P_z, phi_j, cur_j, theta))
        ell0_parts = (const0, phi_l, phi_k, phi_i, phi_y, phi_j, phi_b)

    return dict(P_lam=P_lam, P_c=P_c, P_hz=P_hz, P_hzpi=P_hzpi,
                P_zpi=P_zpi, P_z=P_z, log_A2=log_A2, log_A3=log_A3,
                ell0_parts=ell0_parts)


def _factored_T(model, grids, degree, space, dtype, baseline=None,
                transcendentals="accurate"):
    """Factored contraction operator (quadrature + interp="pre").

    The z_pi contraction runs *before* the z contraction so intermediates
    stay O(N) despite z' conditioning on the current z_pi (see
    :func:`_factored_arrays_gcy` for the axis labels).
    """
    beta, theta = model.beta, model.theta
    arrs = _factored_arrays_gcy(model, grids, degree, baseline)
    P_lam, P_c, P_hz, P_hzpi, P_zpi, P_z = (
        arrs["P_lam"], arrs["P_c"], arrs["P_hz"], arrs["P_hzpi"],
        arrs["P_zpi"], arrs["P_z"])
    log_kappa = arrs["log_A2"][:, None] + arrs["log_A3"][None, :]  # (k, j)
    ell0 = None
    if arrs["ell0_parts"] is not None:
        const0, phi_l, phi_k, phi_i, phi_y, phi_j, phi_b = (
            arrs["ell0_parts"])
        ell0 = jnp.asarray(
            const0
            + phi_l[:, None, None, None, None, None]
            + phi_k[None, :, None, None, None, None]
            + phi_i[None, None, :, None, None, None]
            + phi_y[None, None, None, :, None, None]
            + phi_j[None, None, None, None, :, None]
            + phi_b[None, None, None, None, None, :])

    if dtype is not None:
        (P_lam, P_c, P_hz, P_hzpi, P_zpi, P_z, log_kappa) = (
            a.astype(dtype) for a in
            (P_lam, P_c, P_hz, P_hzpi, P_zpi, P_z, log_kappa))
        if ell0 is not None:
            ell0 = ell0.astype(dtype)

    def apply_K(g):
        u = jnp.einsum("lL,LKIYJB->lKIYJB", P_lam, g, precision=_HI)
        u = jnp.einsum("kK,lKIYJB->lkIYJB", P_c, u, precision=_HI)
        u = jnp.einsum("iI,lkIYJB->lkiYJB", P_hz, u, precision=_HI)
        u = jnp.einsum("yY,lkiYJB->lkiyJB", P_hzpi, u, precision=_HI)
        # next-z_pi first
        u = jnp.einsum("ybB,lkiyJB->lkiyJb", P_zpi, u, precision=_HI)
        # then next-z
        u = jnp.einsum("ijbJ,lkiyJb->lkiyjb", P_z, u, precision=_HI)
        return u

    expand = (None, slice(None), None, None, slice(None), None)  # (k, j)

    if space == "w":
        kappa = jnp.exp(log_kappa)

        def T(w):
            kg = kappa[expand] * apply_K(w ** theta)
            return 1.0 + beta * kg ** (1.0 / theta)
    else:
        from functools import partial

        from ..ops.contract import lse_matmul
        lse = partial(lse_matmul, transcendentals=transcendentals)
        theta_c = jnp.asarray(theta, dtype or jnp.float64)

        def T(ell):
            a = theta_c * (ell if ell0 is None else ell - ell0)
            a = lse(P_lam, a, "lL,LKIYJB->lKIYJB", 0)
            a = lse(P_c, a, "kK,lKIYJB->lkIYJB", 1)
            a = lse(P_hz, a, "iI,lkIYJB->lkiYJB", 2)
            a = lse(P_hzpi, a, "yY,lkiYJB->lkiyJB", 3)
            a = lse(P_zpi, a, "ybB,lkiyJB->lkiyJb", 5)
            a = lse(P_z, a, "ijbJ,lkiyJb->lkiyjb", 4)
            if ell0 is not None:
                a = a + theta_c * ell0
            log_kg = a + log_kappa[expand]
            return jnp.log1p(beta * jnp.exp(log_kg / theta_c))

        if ell0 is not None:
            T.baseline_log_w = ell0

    return T


def T_gcy_continuous_factory(model: GCY,
                             grids: Sequence[jnp.ndarray],
                             *,
                             method: str = "quadrature",
                             interp: str = "pre",
                             space: str = "w",
                             quad_degree: int = 5,
                             mc_draw_size: int = 2000,
                             seed: int = 1234,
                             batch_size: Optional[int] = None,
                             baseline: Optional[str] = None,
                             dtype=None,
                             engine: str = "auto",
                             transcendentals: str = "accurate",
                             jit: bool = True) -> Callable:
    """Build the continuous-state GCY operator T (see the SSY twin for the
    method/interp/space semantics; baseline='loglinear' is effectively
    required for float32 — theta*(log-w range) ~ 200 on these grids).

    post/loglin in log space dispatch to the node-chain reformulation
    (per-node basis matmuls, :mod:`.post_interp`) unless
    ``engine="gather"`` forces the pointwise corner-gather path.  At six
    states a d-degree tensor quadrature has d^6 joint nodes, so Monte
    Carlo draws are the practical expectation for these semantics.
    """
    if space not in ("w", "log"):
        raise ValueError(f"unknown space {space!r}")
    if space == "log" and baseline is None:
        from ..models.gcy import gcy_loglinear_factory
        from .continuous_common import warn_if_f32_range_unsafe
        warn_if_f32_range_unsafe(model, grids, gcy_loglinear_factory,
                                 dtype or jnp.float64)
    if baseline is not None and baseline != "loglinear" \
            and not (isinstance(baseline, tuple) and len(baseline) == 2):
        raise ValueError(f"unknown baseline {baseline!r}")
    if baseline and not (method == "quadrature" and interp == "pre"
                         and space == "log"):
        raise ValueError("baseline normalization requires quadrature + "
                         "interp='pre' + space='log'")
    if engine not in ("auto", "node_chain", "gather"):
        raise ValueError(f"unknown engine {engine!r}")
    if transcendentals != "accurate" and not (
            method == "quadrature" and interp == "pre" and space == "log"):
        # Only the factored log-space LSE chain routes through the
        # selectable transcendentals; silently ignoring the knob on the
        # node-chain/gather/w-space paths would misreport a speed tier.
        import warnings
        warnings.warn(
            f"transcendentals={transcendentals!r} has no effect on this "
            "path (only the factored quadrature + interp='pre' + "
            "space='log' chain uses it)", stacklevel=2)
    if method == "quadrature" and interp == "pre" and engine == "auto":
        T = _factored_T(model, grids, quad_degree, space, dtype, baseline,
                        transcendentals=transcendentals)
    elif (interp in ("post", "loglin") and space == "log"
          and engine in ("auto", "node_chain")
          and method in ("quadrature", "monte_carlo")):
        import numpy as np

        from .post_interp import gcy_quadrature_nodes, make_node_chain_T_gcy
        if method == "quadrature":
            nodes, logw = gcy_quadrature_nodes(quad_degree)
        else:
            key = jax.random.PRNGKey(seed)
            nodes = np.asarray(
                jax.random.normal(key, (6, mc_draw_size),
                                  dtype=jnp.result_type(grids[0])),
                np.float64)
            logw = np.full(mc_draw_size, -np.log(float(mc_draw_size)))
        T = make_node_chain_T_gcy(model, grids, nodes, logw, interp=interp,
                                  dtype=dtype)
    elif engine == "node_chain":
        raise ValueError("engine='node_chain' requires interp='post' or "
                         "'loglin' with space='log'")
    elif method in ("quadrature", "monte_carlo"):
        if method == "quadrature":
            nodes, weights = tensor_quadrature_normal([quad_degree] * 6)
            shocks, weights = jnp.asarray(nodes), jnp.asarray(weights)
        else:
            key = jax.random.PRNGKey(seed)
            shocks = jax.random.normal(key, (6, mc_draw_size),
                                       dtype=jnp.result_type(grids[0]))
            weights = None
        T = make_gather_T(
            lambda x, s: next_state_gcy(model, x, s),
            lambda x: _log_kappa_gcy(model, x[1], x[4]),
            grids, shocks, weights, interp, space, batch_size,
            model.beta, model.theta)
    else:
        raise ValueError(f"unknown method {method!r}")
    out = jax.jit(T) if jit else T
    if hasattr(T, "baseline_log_w"):
        out.baseline_log_w = T.baseline_log_w
    return out
