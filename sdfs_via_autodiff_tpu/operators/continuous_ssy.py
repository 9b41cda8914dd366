"""Continuous-state Koopmans operator for the SSY model.

State grids (h_lam, h_c, h_z, z) with multilinear interpolation of w.
Parity targets: reference ``code/ssy/continuous_junnan/
ssy_wc_ratio_continuous.py`` — ``next_state`` (:63-83), the vmapped MC and
quadrature kernels ``Kg_vmap_mc``/``Kg_vmap_quad`` (:90-153), and the
batched operator factory ``T_fun_factory`` (:156-226).

Interpolation spaces (``interp``):

* ``"post"``  — interpolate w, then raise to theta (the reference's
  semantics, ``ssy_wc_ratio_continuous.py:111,146``): gather path.
* ``"pre"``   — interpolate g = w^theta: the tensor-product quadrature
  expectation then *factorizes* into per-axis contraction matrices (see
  :mod:`.continuous_common`) — the fast path, matmuls instead of
  gathers.  Agrees with "post" in the fine-grid limit.
* ``"loglin"``— interpolate log w, then exponentiate (the reference's
  log-interpolation experiment, ``test_newton.md:69-154``).

``space="log"`` (iterate on log w) is available for every variant and is
required in float32, where w^theta underflows the exponent range.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp

from ..models.ssy import SSY
from ..ops.grids import build_grid_ssy
from ..ops.quadrature import gauss_hermite_normal, tensor_quadrature_normal
from .continuous_common import expectation_matrix, make_gather_T

# Keep float32 operands in float32 on the GPU (its default is TF32, which
# keeps about three digits); a no-op for float64.
_HI = jax.lax.Precision.HIGHEST

__all__ = ["next_state_ssy", "T_ssy_continuous_factory", "build_grid_ssy"]


def next_state_ssy(model: SSY, x: jnp.ndarray, shocks: jnp.ndarray) -> jnp.ndarray:
    """One step of the four SSY state processes.

    ``x`` has leading axis (h_lam, h_c, h_z, z); ``shocks`` is (4, N) (or
    broadcastable).  Parity: reference ``next_state``
    (``ssy_wc_ratio_continuous.py:63-83``).
    """
    m = model
    h_lam, h_c, h_z, z = x[0], x[1], x[2], x[3]
    sigma_z = m.phi_z * jnp.exp(h_z)
    return jnp.stack([
        m.rho_lam * h_lam + m.s_lam * shocks[0],
        m.rho_c * h_c + m.s_c * shocks[1],
        m.rho_z * h_z + m.s_z * shocks[2],
        m.rho * z + sigma_z * shocks[3],
    ])


def _log_kappa_ssy(model: SSY, h_c, z):
    """log kappa(h_c, z) = (1-gamma)(mu_c+z) + (1/2)(1-gamma)^2 sigma_c^2,
    sigma_c = phi_c*exp(h_c) (reference ``ssy_wc_ratio_continuous.py:
    102-103``)."""
    sigma_c = model.phi_c * jnp.exp(h_c)
    return ((1 - model.gamma) * (model.mu_c + z)
            + 0.5 * (1 - model.gamma) ** 2 * sigma_c ** 2)


def _factored_arrays_ssy(model, grids, degree, baseline=None,
                         tilt_lambda=True) -> dict:
    """Expectation matrices + baseline components of the factored operator.

    Shared by :func:`_factored_T` and the two-phase operand set
    (``operators/two_phase.py``).  Returns P_lam (l), P_c (k), P_hz (i),
    P_z (i, j, j'), the split kappa terms log_A2 (k) / log_A3 (j) with
    log kappa(h_c, z) = log_A2[k] + log_A3[j], and — when a baseline is
    folded — the separable components (A0, phi_l, phi_k, phi_i, phi_j).
    """
    theta = model.theta
    m = model
    h_lam_grid, h_c_grid, h_z_grid, z_grid = grids
    eta, omega = map(jnp.asarray, gauss_hermite_normal(degree))

    P_lam = expectation_matrix(h_lam_grid, m.rho_lam * h_lam_grid, m.s_lam,
                               eta, omega,
                               payoff=(lambda xn: jnp.exp(theta * xn))
                               if tilt_lambda else None)
    P_c = expectation_matrix(h_c_grid, m.rho_c * h_c_grid, m.s_c, eta, omega)
    P_hz = expectation_matrix(h_z_grid, m.rho_z * h_z_grid, m.s_z, eta, omega)
    sigma_z = m.phi_z * jnp.exp(h_z_grid)
    # z' = rho*z + sigma_z(h_z)*eta depends on (h_z, z): P_z[i, j, j'].
    P_z = expectation_matrix(z_grid,
                             jnp.broadcast_to(m.rho * z_grid,
                                              (len(h_z_grid), len(z_grid))),
                             sigma_z[:, None], eta, omega)
    # log kappa(h_c, z) splits into a row (h_c) and a column (z) part.
    sigma_c = m.phi_c * jnp.exp(h_c_grid)
    log_A2 = 0.5 * (1 - m.gamma) ** 2 * sigma_c ** 2               # (k,)
    log_A3 = (1 - m.gamma) * (m.mu_c + z_grid)                     # (j,)

    ell0_parts = None
    if baseline is not None:
        # Fold a separable baseline into the expectation matrices: the
        # chain then works on theta*(ell - ell0), keeping wide-range grids
        # inside f32.  baseline is "loglinear" (closed form) or
        # (const, [per-axis profiles]) from e.g. additive_profiles() on a
        # coarse solve.  Exact telescoping; see continuous_common.
        import numpy as np
        from .continuous_common import normalize_expectation_matrix
        if baseline == "loglinear":
            from ..models.ssy import ssy_loglinear_factory
            co = ssy_loglinear_factory(m).coefficients
            hl = np.asarray(h_lam_grid, np.float64)
            hc = np.asarray(h_c_grid, np.float64)
            hz = np.asarray(h_z_grid, np.float64)
            zg = np.asarray(z_grid, np.float64)
            const0 = co["A0"]
            phi_l = co["A_hlam"] * hl
            phi_k = co["A_hc"] * (hc * 2 * m.phi_c**2 + m.phi_c**2)
            phi_i = co["A_hz"] * (hz * 2 * m.phi_z**2 + m.phi_z**2)
            phi_j = co["A_z"] * zg
        else:
            const0, (phi_l, phi_k, phi_i, phi_j) = baseline
            phi_l, phi_k, phi_i, phi_j = (np.asarray(p_, np.float64)
                                          for p_ in (phi_l, phi_k, phi_i,
                                                     phi_j))
        P_lam = jnp.asarray(normalize_expectation_matrix(
            P_lam, phi_l, phi_l, theta))
        P_c = jnp.asarray(normalize_expectation_matrix(
            P_c, phi_k, phi_k, theta))
        P_hz = jnp.asarray(normalize_expectation_matrix(
            P_hz, phi_i, phi_i, theta))
        P_z = jnp.asarray(normalize_expectation_matrix(
            P_z, phi_j, np.broadcast_to(phi_j, P_z.shape[:-1]), theta))
        ell0_parts = (const0, phi_l, phi_k, phi_i, phi_j)

    return dict(P_lam=P_lam, P_c=P_c, P_hz=P_hz, P_z=P_z,
                log_A2=log_A2, log_A3=log_A3, ell0_parts=ell0_parts)


def _factored_T(model, grids, degree, space, dtype, baseline=None,
                transcendentals="accurate"):
    """Factored per-axis contraction operator (quadrature + interp="pre").

    Per-dimension expectation matrices from 1-D Gauss-Hermite rules —
    exactly equivalent to the tensor-product rule by separability of the
    multilinear basis.  Axis labels: l=h_lam, k=h_c, i=h_z, j=z.
    """
    beta, theta = model.beta, model.theta
    arrs = _factored_arrays_ssy(model, grids, degree, baseline)
    P_lam, P_c, P_hz, P_z = (arrs["P_lam"], arrs["P_c"], arrs["P_hz"],
                             arrs["P_z"])
    log_kappa = arrs["log_A2"][:, None] + arrs["log_A3"][None, :]  # (k, j)
    ell0 = None
    if arrs["ell0_parts"] is not None:
        const0, phi_l, phi_k, phi_i, phi_j = arrs["ell0_parts"]
        ell0 = jnp.asarray(
            const0 + phi_l[:, None, None, None] + phi_k[None, :, None, None]
            + phi_i[None, None, :, None] + phi_j[None, None, None, :])

    if dtype is not None:
        P_lam, P_c, P_hz, P_z, log_kappa = (
            a.astype(dtype) for a in (P_lam, P_c, P_hz, P_z, log_kappa))
        if ell0 is not None:
            ell0 = ell0.astype(dtype)

    def apply_K(g):
        u = jnp.einsum("lL,LKIJ->lKIJ", P_lam, g, precision=_HI)
        u = jnp.einsum("kK,lKIJ->lkIJ", P_c, u, precision=_HI)
        u = jnp.einsum("iI,lkIJ->lkiJ", P_hz, u, precision=_HI)
        u = jnp.einsum("ijJ,lkiJ->lkij", P_z, u, precision=_HI)
        return u

    if space == "w":
        kappa = jnp.exp(log_kappa)

        def T(w):
            kg = kappa[None, :, None, :] * apply_K(w ** theta)
            return 1.0 + beta * kg ** (1.0 / theta)
    else:
        from functools import partial

        from ..ops.contract import lse_matmul
        lse = partial(lse_matmul, transcendentals=transcendentals)
        theta_c = jnp.asarray(theta, dtype or jnp.float64)

        def T(ell):
            a = theta_c * (ell if ell0 is None else ell - ell0)
            a = lse(P_lam, a, "lL,LKIJ->lKIJ", 0)
            a = lse(P_c, a, "kK,lKIJ->lkIJ", 1)
            a = lse(P_hz, a, "iI,lkIJ->lkiJ", 2)
            a = lse(P_z, a, "ijJ,lkiJ->lkij", 3)
            if ell0 is not None:
                a = a + theta_c * ell0
            log_kg = a + log_kappa[None, :, None, :]
            return jnp.log1p(beta * jnp.exp(log_kg / theta_c))

        if ell0 is not None:
            T.baseline_log_w = ell0

    return T


def T_ssy_continuous_factory(model: SSY,
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
    """Build the continuous-state SSY operator T.

    method="quadrature" uses degree-``quad_degree`` Gauss-Hermite per
    dimension (reference default d=5, ``ssy_wc_ratio_continuous.py:232``);
    "monte_carlo" uses ``mc_draw_size`` joint draws (reference :231,
    default 2000).

    quadrature + interp="pre" dispatches to the factored contraction path;
    post/loglin in log space dispatch to the node-chain reformulation
    (per-node basis matmuls + streaming LSE, :mod:`.post_interp`) unless
    ``engine="gather"`` forces the pointwise vmapped gather path, which
    also serves the remaining combinations with optional ``batch_size``
    chunking (replacing the reference's RAM-free heuristic,
    ``ssy_wc_ratio_continuous.py:271-285``).
    """
    if space not in ("w", "log"):
        raise ValueError(f"unknown space {space!r}")
    if space == "log" and baseline is None:
        from ..models.ssy import ssy_loglinear_factory
        from .continuous_common import warn_if_f32_range_unsafe
        warn_if_f32_range_unsafe(model, grids, ssy_loglinear_factory,
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

        from .post_interp import make_node_chain_T_ssy, ssy_quadrature_nodes
        if method == "quadrature":
            nodes, logw = ssy_quadrature_nodes(quad_degree)
        else:
            key = jax.random.PRNGKey(seed)
            nodes = np.asarray(
                jax.random.normal(key, (4, mc_draw_size),
                                  dtype=jnp.result_type(grids[0])),
                np.float64)
            logw = np.full(mc_draw_size, -np.log(float(mc_draw_size)))
        T = make_node_chain_T_ssy(model, grids, nodes, logw, interp=interp,
                                  dtype=dtype)
    elif engine == "node_chain":
        raise ValueError("engine='node_chain' requires interp='post' or "
                         "'loglin' with space='log'")
    elif method in ("quadrature", "monte_carlo"):
        if method == "quadrature":
            nodes, weights = tensor_quadrature_normal([quad_degree] * 4)
            shocks, weights = jnp.asarray(nodes), jnp.asarray(weights)
        else:
            key = jax.random.PRNGKey(seed)
            shocks = jax.random.normal(key, (4, mc_draw_size),
                                       dtype=jnp.result_type(grids[0]))
            weights = None
        T = make_gather_T(
            lambda x, s: next_state_ssy(model, x, s),
            lambda x: _log_kappa_ssy(model, x[1], x[3]),
            grids, shocks, weights, interp, space, batch_size,
            model.beta, model.theta)
    else:
        raise ValueError(f"unknown method {method!r}")
    out = jax.jit(T) if jit else T
    if hasattr(T, "baseline_log_w"):
        out.baseline_log_w = T.baseline_log_w
    return out
