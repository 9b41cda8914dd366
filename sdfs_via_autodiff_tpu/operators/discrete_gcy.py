"""Discrete (Rouwenhorst tensor-grid) Koopmans operator for the GCY model.

Six-state analogue of :mod:`.discrete_ssy`.  The reference broadcasts a
12-axis product tensor (reference ``code/gcy/discrete/gcy_wc_ratio.py:
134-238``); here ``H w^theta`` is a chain of six per-axis contractions.

State order in w (reference loop oracle ``gcy_wc_ratio.py:296-298``):

    w[i_z, i_z_pi, i_h_z, i_h_c, i_h_zpi, i_h_lam]

Discretization structure (reference ``gcy_wc_ratio.py:31-131``):

* independent Rouwenhorst chains for h_z, h_c, h_zpi, h_lam;
* z_pi chains conditional on h_zpi: z_pi_states[i_h_zpi, i_z_pi];
* z chains conditional on (z_pi, h_z, h_zpi) including the mean shift
  rho_pi * z_pi: z_states[i_z_pi, i_h_z, i_h_zpi, i_z].

All conditional chains share persistence, hence share one transition matrix
each (``z_pi_P``, ``z_P``) — only the state ladders are scaled/shifted.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.gcy import GCY
from ..ops.rouwenhorst import rouwenhorst, rouwenhorst_P, rouwenhorst_ladder
from ..ops.tauchen import tauchen, tauchen_P, tauchen_ladder

# Keep float32 operands in float32 on the GPU (its default is TF32, which
# keeps about three digits); a no-op for float64.
_HI = jax.lax.Precision.HIGHEST

__all__ = ["GCYDiscretization", "discretize_gcy", "T_gcy_factory",
           "dense_H_gcy", "gcy_loglinear_parts"]


@dataclasses.dataclass(frozen=True)
class GCYDiscretization:
    shapes: Tuple[int, int, int, int, int, int]   # (n_z, n_z_pi, n_h_z, n_h_c, n_h_zpi, n_h_lam)
    h_z_states: jnp.ndarray
    h_z_Q: jnp.ndarray
    h_c_states: jnp.ndarray
    h_c_Q: jnp.ndarray
    h_zpi_states: jnp.ndarray
    h_zpi_Q: jnp.ndarray
    h_lam_states: jnp.ndarray
    h_lam_Q: jnp.ndarray
    z_pi_states: jnp.ndarray   # (n_h_zpi, n_z_pi)
    z_pi_P: jnp.ndarray        # (n_z_pi, n_z_pi), shared over i_h_zpi
    z_states: jnp.ndarray      # (n_z_pi, n_h_z, n_h_zpi, n_z)
    z_P: jnp.ndarray           # (n_z, n_z), shared over conditioning states
    sigma_z_states: jnp.ndarray
    sigma_c_states: jnp.ndarray
    sigma_zpi_states: jnp.ndarray

    @property
    def z_pi_Q(self) -> jnp.ndarray:
        """(n_h_zpi, n_z_pi, n_z_pi) family (reference layout,
        ``gcy_wc_ratio.py:93-100``)."""
        n_h_zpi = self.shapes[4]
        return jnp.broadcast_to(self.z_pi_P, (n_h_zpi,) + self.z_pi_P.shape)

    @property
    def z_Q(self) -> jnp.ndarray:
        """(n_z_pi, n_h_z, n_h_zpi, n_z, n_z) family (reference layout,
        ``gcy_wc_ratio.py:109-120``)."""
        n_z, n_z_pi, n_h_z, _, n_h_zpi, _ = self.shapes
        return jnp.broadcast_to(self.z_P,
                                (n_z_pi, n_h_z, n_h_zpi) + self.z_P.shape)

    def as_reference_tuple(self):
        """The 15-tuple layout of reference ``gcy_wc_ratio.py:123-131``."""
        return (self.z_states, self.z_Q,
                self.z_pi_states, self.z_pi_Q,
                self.h_z_states, self.h_z_Q, self.sigma_z_states,
                self.h_c_states, self.h_c_Q, self.sigma_c_states,
                self.h_zpi_states, self.h_zpi_Q, self.sigma_zpi_states,
                self.h_lam_states, self.h_lam_Q)


def discretize_gcy(model: GCY, shapes: Tuple[int, ...],
                   dtype=jnp.float64,
                   method: str = "rouwenhorst") -> GCYDiscretization:
    """Discretization of the six GCY states (method="rouwenhorst" is
    parity with reference ``discretize_gcy``, ``gcy_wc_ratio.py:31-131``;
    "tauchen" swaps the construction, same shared-matrix structure)."""
    n_z, n_z_pi, n_h_z, n_h_c, n_h_zpi, n_h_lam = shapes
    m = model
    if method == "rouwenhorst":
        chain, chain_P, chain_ladder = rouwenhorst, rouwenhorst_P, rouwenhorst_ladder
    elif method == "tauchen":
        chain, chain_P, chain_ladder = tauchen, tauchen_P, tauchen_ladder
    else:
        raise ValueError(f"unknown discretization method {method!r}")

    h_z_states, h_z_Q = chain(n_h_z, m.rho_z, m.s_z)
    h_c_states, h_c_Q = chain(n_h_c, m.rho_c, m.s_c)
    h_zpi_states, h_zpi_Q = chain(n_h_zpi, m.rho_zpi, m.s_zpi)
    h_lam_states, h_lam_Q = chain(n_h_lam, m.rho_lam, m.s_lam)

    sigma_z_states = m.phi_z * np.exp(h_z_states)
    sigma_c_states = m.phi_c * np.exp(h_c_states)
    sigma_zpi_states = m.phi_zpi * np.exp(h_zpi_states)

    # z_pi' = rho_pipi*z_pi + sigma_zpi*eta: ladder scaled per h_zpi state.
    zpi_ladder = chain_ladder(n_z_pi, m.rho_pipi)
    z_pi_states = sigma_zpi_states[:, None] * zpi_ladder[None, :]
    z_pi_P = chain_P(n_z_pi, m.rho_pipi)

    # z' = rho*z + rho_pi*z_pi + sigma_z*eta: ladder scaled by sigma_z[i_h_z]
    # and mean-shifted by rho_pi*z_pi/(1-rho) per (i_h_zpi, i_z_pi).
    z_ladder = chain_ladder(n_z, m.rho)
    centers = (m.rho_pi / (1.0 - m.rho)) * z_pi_states      # (n_h_zpi, n_z_pi)
    spread = sigma_z_states[:, None] * z_ladder[None, :]    # (n_h_z, n_z)
    # target layout: (i_z_pi, i_h_z, i_h_zpi, i_z)
    z_states = (centers.T[:, None, :, None] + spread[None, :, None, :])
    z_P = chain_P(n_z, m.rho)

    cast = lambda a: jnp.asarray(a, dtype=dtype)
    return GCYDiscretization(
        shapes=tuple(shapes),
        h_z_states=cast(h_z_states), h_z_Q=cast(h_z_Q),
        h_c_states=cast(h_c_states), h_c_Q=cast(h_c_Q),
        h_zpi_states=cast(h_zpi_states), h_zpi_Q=cast(h_zpi_Q),
        h_lam_states=cast(h_lam_states), h_lam_Q=cast(h_lam_Q),
        z_pi_states=cast(z_pi_states), z_pi_P=cast(z_pi_P),
        z_states=cast(z_states), z_P=cast(z_P),
        sigma_z_states=cast(sigma_z_states),
        sigma_c_states=cast(sigma_c_states),
        sigma_zpi_states=cast(sigma_zpi_states),
    )


def _gcy_factors(model: GCY, disc: GCYDiscretization):
    theta, gamma = model.theta, model.gamma
    # B_lam[i_h_lam, j_h_lam] = Q_lam * exp(theta * h_lam')
    B_lam = disc.h_lam_Q * jnp.exp(theta * disc.h_lam_states)[None, :]
    A2 = jnp.exp(0.5 * ((1 - gamma) * disc.sigma_c_states) ** 2)  # (i_h_c,)
    # A3 over current (i_z, i_z_pi, i_h_z, i_h_zpi); z_states has layout
    # (i_z_pi, i_h_z, i_h_zpi, i_z) -> move i_z to the front.
    A3 = jnp.exp((1 - gamma) * (model.mu_c
                                + jnp.transpose(disc.z_states, (3, 0, 1, 2))))
    return B_lam, A2, A3


def T_gcy_factory(model: GCY,
                  disc: GCYDiscretization,
                  *,
                  space: str = "w",
                  baseline: Optional[str] = None,
                  dtype=None,
                  transcendentals: str = "accurate",
                  jit: bool = True) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Koopmans operator T for the discretized GCY model as a chain of six
    per-axis contractions (replaces the 12-axis broadcast of reference
    ``T_gcy``, ``gcy_wc_ratio.py:134-238``).

    Axis labels in the einsums: a=z, b=z_pi, c=h_z, d=h_c, e=h_zpi,
    l=h_lam; capital = next-period index.

    baseline="loglinear" (log space only): baseline-normalized variant —
    see :func:`_T_gcy_normalized`.
    """
    if space not in ("w", "log"):
        raise ValueError(f"unknown space {space!r}")
    if baseline not in (None, "loglinear"):
        raise ValueError(f"unknown baseline {baseline!r}")
    if baseline and space != "log":
        raise ValueError("baseline normalization requires space='log'")
    if baseline:
        return _T_gcy_normalized(model, disc, dtype=dtype,
                                 transcendentals=transcendentals, jit=jit)
    beta, theta = model.beta, model.theta
    B_lam, A2, A3 = _gcy_factors(model, disc)
    Qc, Qhz, Qhzpi = disc.h_c_Q, disc.h_z_Q, disc.h_zpi_Q
    zpiP, zP = disc.z_pi_P, disc.z_P
    if dtype is not None:
        (B_lam, A2, A3, Qc, Qhz, Qhzpi, zpiP, zP) = (
            a.astype(dtype)
            for a in (B_lam, A2, A3, Qc, Qhz, Qhzpi, zpiP, zP))

    def apply_H(v):
        # next-h_lam
        u = jnp.einsum("lL,ABCDEL->ABCDEl", B_lam, v, precision=_HI)
        u = jnp.einsum("dD,ABCDEl->ABCdEl", Qc, u, precision=_HI)  # next-h_c
        u = jnp.einsum("cC,ABCdEl->ABcdEl", Qhz, u, precision=_HI)  # next-h_z
        # next-h_zpi
        u = jnp.einsum("eE,ABcdEl->ABcdel", Qhzpi, u, precision=_HI)
        # next-z_pi
        u = jnp.einsum("bB,ABcdel->Abcdel", zpiP, u, precision=_HI)
        u = jnp.einsum("aA,Abcdel->abcdel", zP, u, precision=_HI)      # next-z
        return u

    if space == "w":
        def T(w):
            u = apply_H(w ** theta)
            hwt = (A2[None, None, None, :, None, None]
                   * A3[:, :, :, None, :, None] * u)
            return 1.0 + beta * hwt ** (1.0 / theta)
    else:
        from functools import partial

        from ..ops.contract import lse_matmul
        lse = partial(lse_matmul, transcendentals=transcendentals)
        log_A2 = jnp.log(A2)
        log_A3 = jnp.log(A3)

        def T(ell):
            # Per-axis log-sum-exp contractions (f32-safe at any range).
            a = theta * ell
            a = lse(B_lam, a, "lL,ABCDEL->ABCDEl", 5)
            a = lse(Qc, a, "dD,ABCDEl->ABCdEl", 3)
            a = lse(Qhz, a, "cC,ABCdEl->ABcdEl", 2)
            a = lse(Qhzpi, a, "eE,ABcdEl->ABcdel", 4)
            a = lse(zpiP, a, "bB,ABcdel->Abcdel", 1)
            a = lse(zP, a, "aA,Abcdel->abcdel", 0)
            log_hwt = (a + log_A2[None, None, None, :, None, None]
                       + log_A3[:, :, :, None, :, None])
            return jnp.log1p(beta * jnp.exp(log_hwt / theta))

    return jax.jit(T) if jit else T


def dense_H_gcy(model: GCY, disc: GCYDiscretization) -> jnp.ndarray:
    """Dense (N, N) single-index H for tiny grids (cross-check path)."""
    B_lam, A2, A3 = _gcy_factors(model, disc)
    H12 = jnp.einsum("aA,bB,cC,dD,eE,lL,d,abce->abcdelABCDEL",
                     disc.z_P, disc.z_pi_P, disc.h_z_Q, disc.h_c_Q,
                     disc.h_zpi_Q, B_lam, A2, A3)
    n = int(np.prod(disc.shapes))
    return H12.reshape(n, n)


def gcy_loglinear_parts(model: GCY, disc: GCYDiscretization) -> dict:
    """Separable components of the GCY log-linear closed form evaluated on
    the discretized grid (host float64); ``ell0`` is the full 6-D field —
    the standard warm start (reference ``test_newton.md:60-66`` practice)
    and the normalized operator's baseline."""
    from ..models.gcy import gcy_loglinear_factory

    m = model
    co = gcy_loglinear_factory(model).coefficients
    h_lam = np.asarray(disc.h_lam_states, np.float64)
    h_c = np.asarray(disc.h_c_states, np.float64)
    h_z = np.asarray(disc.h_z_states, np.float64)
    h_zpi = np.asarray(disc.h_zpi_states, np.float64)
    zpi = np.asarray(disc.z_pi_states, np.float64)      # (e, b)
    # z_states layout (b, c, e, a) = (i_z_pi, i_h_z, i_h_zpi, i_z)
    zst = np.asarray(disc.z_states, np.float64)

    phi_l = co["A_hlam"] * h_lam
    phi_d = co["A_hc"] * (h_c * 2 * m.phi_c**2 + m.phi_c**2)
    phi_c_ = co["A_hz"] * (h_z * 2 * m.phi_z**2 + m.phi_z**2)
    phi_e = co["A_hzpi"] * (h_zpi * 2 * m.phi_zpi**2 + m.phi_zpi**2)
    psi_pi = co["A_zpi"] * zpi                          # (e, b)
    psi_z = co["A_z"] * zst                             # (b, c, e, a)

    # ell0 on the (a, b, c, d, e, l) grid.
    ell0 = (co["A0"]
            + psi_z.transpose(3, 0, 1, 2)[:, :, :, None, :, None]
            + psi_pi.T[None, :, None, None, :, None]
            + phi_c_[None, None, :, None, None, None]
            + phi_d[None, None, None, :, None, None]
            + phi_e[None, None, None, None, :, None]
            + phi_l[None, None, None, None, None, :])
    return dict(co=co, h_lam=h_lam, h_c=h_c, h_z=h_z, h_zpi=h_zpi,
                phi_l=phi_l, phi_d=phi_d, phi_c_=phi_c_, phi_e=phi_e,
                psi_pi=psi_pi, psi_z=psi_z, ell0=ell0)


def _T_gcy_normalized(model: GCY, disc: GCYDiscretization, *, dtype=None,
                      transcendentals: str = "accurate", jit: bool = True):
    """Log-space GCY operator with the log-linear baseline folded in.

    Six-state analogue of the SSY normalization (see
    ``discrete_ssy._T_ssy_normalized``): the separable log-linear
    approximation ell0 distributes into the per-axis transition factors
    with exact telescoping across the coupled terms (z_pi couples
    (h_zpi, z_pi); z couples (z_pi, h_z, h_zpi, z), so those components
    ride the contractions as conditioning batch axes).  Assembled in host
    float64; keeps every device intermediate at O(exp(theta*(ell-ell0))).
    """
    from functools import partial

    from ..ops.contract import lse_matmul

    theta, beta, gamma = model.theta, model.beta, model.gamma
    # dtype=None means keep float64 (every other operator path's
    # convention); the f32 scale tier is an explicit request.
    work_dtype = dtype or jnp.float64
    # f32: the wide-Rouwenhorst ladders this normalized tier exists for
    # put localized next-state rows' whole mass below the per-slice
    # shift's ~87-nat window (measured: first application -inf/NaN at
    # the 25.2M north-star grid) — enable lse_matmul's deeper matmul
    # windows.  Three passes: the measured stage depths reach 183 nats
    # at the north-star widths (> the 167-nat two-pass union; CPU f32
    # masks this via subnormals, a device that flushes them does not).
    lse = partial(lse_matmul, transcendentals=transcendentals,
                  deep_window=80.0 if work_dtype == jnp.float32 else 0.0,
                  deep_passes=3)
    m = model

    parts = gcy_loglinear_parts(model, disc)
    h_lam = parts["h_lam"]
    phi_l, phi_d, phi_c_, phi_e = (parts["phi_l"], parts["phi_d"],
                                   parts["phi_c_"], parts["phi_e"])
    psi_pi, psi_z, ell0 = parts["psi_pi"], parts["psi_z"], parts["ell0"]
    zst = np.asarray(disc.z_states, np.float64)         # (b, c, e, a)

    with np.errstate(divide="ignore"):
        logQ = lambda P: np.log(np.asarray(P, np.float64))
        lQlam = logQ(disc.h_lam_Q)
        lQc = logQ(disc.h_c_Q)
        lQhz = logQ(disc.h_z_Q)
        lQhzpi = logQ(disc.h_zpi_Q)
        lzpiP = logQ(disc.z_pi_P)
        lzP = logQ(disc.z_P)

    t = theta
    # Matrices are assembled IN LOG DOMAIN and row-normalized before the
    # only exp (ops/contract.normalize_rows_log): the folded baseline
    # factors reach e^{+-hundreds} on wide-Rouwenhorst ladders, so an
    # un-normalized np.exp + astype(f32) makes inf/0 entries (measured
    # at the 25.2M north-star case: inf rowsums -> NaN everywhere).
    # The exact per-row log-sums ride the chain as output adds.
    from ..ops.contract import normalize_rows_log

    logM1 = lQlam + t * (h_lam + phi_l)[None, :] - t * phi_l[:, None]
    logM2 = lQc + t * (phi_d[None, :] - phi_d[:, None])
    # M3[A,B,E,c,C]: contract next-h_z at fixed (A,B,E); psi_z's
    # C-dependence folds here, rescaled by the current-c slice.
    psz_ABEC = psi_z.transpose(3, 0, 2, 1)              # (A, B, E, C)
    logM3 = (lQhz[None, None, None, :, :]
             + t * (phi_c_[None, None, None, None, :]
                    - phi_c_[None, None, None, :, None]
                    + psz_ABEC[:, :, :, None, :]
                    - psz_ABEC[:, :, :, :, None]))
    # M4[A,B,c,e,E]: contract next-h_zpi; folds phi_e, psi_pi's
    # E-dependence, and psi_z's E-dependence.
    psz_ABCE = psi_z.transpose(3, 0, 1, 2)              # (A, B, C, E)
    psipi_BE = psi_pi.T                                  # (B, E)
    logM4 = (lQhzpi[None, None, None, :, :]
             + t * (phi_e[None, None, None, None, :]
                    - phi_e[None, None, None, :, None]
                    + psipi_BE[None, :, None, None, :]
                    - psipi_BE[None, :, None, :, None]
                    + psz_ABCE[:, :, :, None, :]
                    - psz_ABCE[:, :, :, :, None]))
    # M5[A,c,e,b,B]: contract next-z_pi; folds psi_pi's B-dependence and
    # psi_z's B-dependence.
    psz_ACEB = psi_z.transpose(3, 1, 2, 0)              # (A, C, E, B)
    logM5 = (lzpiP[None, None, None, :, :]
             + t * (psipi_BE.T[None, None, :, None, :]
                    - psipi_BE.T[None, None, :, :, None]
                    + psz_ACEB[:, :, :, None, :]
                    - psz_ACEB[:, :, :, :, None]))
    # M6[b,c,e,a,A]: contract next-z; folds psi_z's A-dependence.
    psz_BCEA = psi_z                                    # (B, C, E, A)
    logM6 = (lzP[None, None, None, :, :]
             + t * (psz_BCEA[:, :, :, None, :]
                    - psz_BCEA[:, :, :, :, None]))

    SUBS = ("lL,ABCDEL->ABCDEl", "dD,ABCDEl->ABCdEl",
            "ABEcC,ABCdEl->ABcdEl", "ABceE,ABcdEl->ABcdel",
            "AcebB,ABcdel->Abcdel", "bceaA,Abcdel->abcdel")
    AXES = (5, 3, 2, 4, 1, 0)
    Ms, log_ss = [], []
    for logM, subs, ax in zip((logM1, logM2, logM3, logM4, logM5, logM6),
                              SUBS, AXES):
        Mn, ls = normalize_rows_log(logM, subs, ax)
        Ms.append(Mn)
        log_ss.append(ls)

    A2 = np.exp(0.5 * ((1 - gamma) * np.asarray(disc.sigma_c_states)) ** 2)
    log_A2 = np.log(A2)
    log_A3 = (1 - gamma) * (m.mu_c + zst.transpose(3, 0, 1, 2))  # (a,b,c,e)

    cast = lambda x: jnp.asarray(x, work_dtype)
    Ms = [cast(M) for M in Ms]
    log_ss = [cast(ls) for ls in log_ss]
    ell0_j = cast(ell0)
    log_A2 = cast(log_A2)
    log_A3 = cast(log_A3)
    t_c = jnp.asarray(theta, work_dtype)

    def T(ell):
        a = t_c * (ell - ell0_j)
        for M, ls, subs, ax in zip(Ms, log_ss, SUBS, AXES):
            a = lse(M, a, subs, ax) + ls
        log_hwt = (t_c * ell0_j + a
                   + log_A2[None, None, None, :, None, None]
                   + log_A3[:, :, :, None, :, None])
        return jnp.log1p(beta * jnp.exp(log_hwt / t_c))

    T = jax.jit(T) if jit else T
    T.baseline_log_w = ell0_j
    return T
