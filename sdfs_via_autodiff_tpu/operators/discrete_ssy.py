"""Discrete (Rouwenhorst tensor-grid) Koopmans operator for the SSY model.

The reference implements ``T_ssy`` by broadcasting an 8-axis product tensor
``H = A1*A2*A3*Q_lam*Q_c*Q_hz*z_Q`` and summing over the four next-state axes
(reference ``code/ssy/discrete/ssy_wc_ratio.py:82-151``) — O(N^2) work and
memory in the number of grid points N.  Because the transition kernel is a
product of per-axis factors, ``H w^theta`` is here computed as a *chain of
per-axis contractions* (skinny matmuls): O(N * sum(n_axis)) FLOPs and O(N)
memory.  This is the central redesign; it is exact (same sum, reordered) and is validated against a loop oracle and a dense-H path in
the tests.

Two operator spaces are provided:

* ``space="w"``: iterate on w directly (matches reference semantics; needs
  float64 because w^theta ~ 1e-47 underflows float32 at theta ~ -16).
* ``space="log"``: iterate on l = log(w); the contraction runs on
  ``exp(theta*l - m)`` with a max-shift m, which keeps every intermediate in
  comfortable float32 range.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.ssy import SSY
from ..ops.rouwenhorst import rouwenhorst, rouwenhorst_P, rouwenhorst_ladder
from ..ops.tauchen import tauchen, tauchen_P, tauchen_ladder

# Keep float32 operands in float32 on the GPU (its default is TF32, which
# keeps about three digits); a no-op for float64.
_HI = jax.lax.Precision.HIGHEST

__all__ = ["SSYDiscretization", "discretize_ssy", "T_ssy_factory",
           "dense_H_ssy"]


@dataclasses.dataclass(frozen=True)
class SSYDiscretization:
    """Discrete representation of the SSY state space.

    Index convention (reference ``ssy_wc_ratio.py:31-39``):

        h_lam[l], h_c[k], h_z[i], and z[i, j] — the z grid depends on the
        current h_z index i through sigma_z = phi_z * exp(h_z[i]);
        z_Q[i, j, jp] is the z transition matrix at volatility state i.

    Because the Rouwenhorst transition matrix depends only on the
    persistence, all slices z_Q[i] coincide; ``z_P`` stores that shared
    matrix and the operator contracts against it directly.
    """

    shapes: Tuple[int, int, int, int]
    h_lam_states: jnp.ndarray
    h_lam_Q: jnp.ndarray
    h_c_states: jnp.ndarray
    h_c_Q: jnp.ndarray
    h_z_states: jnp.ndarray
    h_z_Q: jnp.ndarray
    z_states: jnp.ndarray      # (n_h_z, n_z)
    z_P: jnp.ndarray           # (n_z, n_z) shared across volatility states
    sigma_c_states: jnp.ndarray
    sigma_z_states: jnp.ndarray

    @property
    def z_Q(self) -> jnp.ndarray:
        """Full (n_h_z, n_z, n_z) family, materialized on demand (parity
        with the reference's return layout, ``ssy_wc_ratio.py:60-66``)."""
        n_h_z = self.shapes[2]
        return jnp.broadcast_to(self.z_P, (n_h_z,) + self.z_P.shape)

    def as_reference_tuple(self):
        """The 10-tuple layout the reference passes around
        (``ssy_wc_ratio.py:73-79``)."""
        return (self.h_lam_states, self.h_lam_Q,
                self.h_c_states, self.h_c_Q,
                self.h_z_states, self.h_z_Q,
                self.z_states, self.z_Q,
                self.sigma_c_states, self.sigma_z_states)


def discretize_ssy(model: SSY, shapes: Tuple[int, int, int, int],
                   dtype=jnp.float64,
                   method: str = "rouwenhorst") -> SSYDiscretization:
    """Discretization of the four SSY states.

    method="rouwenhorst" matches reference ``discretize_ssy``
    (``ssy_wc_ratio.py:23-79``): one chain per h process; for z, a
    volatility-dependent family of chains z_states[i, :] =
    sigma_z[i] * ladder(rho) sharing one transition matrix.
    method="tauchen" swaps in the Tauchen (1986) construction (same
    shared-matrix structure).  Host-side float64, cast to ``dtype``.
    """
    n_h_lam, n_h_c, n_h_z, n_z = shapes
    m = model
    if method == "rouwenhorst":
        chain, chain_P, chain_ladder = rouwenhorst, rouwenhorst_P, rouwenhorst_ladder
    elif method == "tauchen":
        chain, chain_P, chain_ladder = tauchen, tauchen_P, tauchen_ladder
    else:
        raise ValueError(f"unknown discretization method {method!r}")

    h_lam_states, h_lam_Q = chain(n_h_lam, m.rho_lam, m.s_lam)
    h_c_states, h_c_Q = chain(n_h_c, m.rho_c, m.s_c)
    h_z_states, h_z_Q = chain(n_h_z, m.rho_z, m.s_z)

    sigma_z_states = m.phi_z * np.exp(h_z_states)
    sigma_c_states = m.phi_c * np.exp(h_c_states)

    z_ladder = chain_ladder(n_z, m.rho)
    z_states = sigma_z_states[:, None] * z_ladder[None, :]
    z_P = chain_P(n_z, m.rho)

    cast = lambda a: jnp.asarray(a, dtype=dtype)
    return SSYDiscretization(
        shapes=tuple(shapes),
        h_lam_states=cast(h_lam_states), h_lam_Q=cast(h_lam_Q),
        h_c_states=cast(h_c_states), h_c_Q=cast(h_c_Q),
        h_z_states=cast(h_z_states), h_z_Q=cast(h_z_Q),
        z_states=cast(z_states), z_P=cast(z_P),
        sigma_c_states=cast(sigma_c_states),
        sigma_z_states=cast(sigma_z_states),
    )


def _ssy_factors(model: SSY, disc: SSYDiscretization):
    """Per-axis factors of H.  A1 folds into the h_lam transition matrix."""
    theta = model.theta
    gamma = model.gamma
    # B_lam[l, lp] = Q_lam[l, lp] * exp(theta * h_lam[lp])
    B_lam = disc.h_lam_Q * jnp.exp(theta * disc.h_lam_states)[None, :]
    A2 = jnp.exp(0.5 * ((1 - gamma) * disc.sigma_c_states) ** 2)       # (k,)
    A3 = jnp.exp((1 - gamma) * (model.mu_c + disc.z_states))           # (i, j)
    return B_lam, A2, A3


def _hw_theta_factored(v, B_lam, Qc, Qhz, zP, A2, A3):
    """Chain of per-axis contractions: (H v)[l,k,i,j] for v = w^theta.

    Each step is one dot_general; intermediates stay O(N).
    """
    # contract next-h_lam
    u = jnp.einsum("lm,mkij->lkij", B_lam, v, precision=_HI)
    u = jnp.einsum("km,lmij->lkij", Qc, u, precision=_HI)  # contract next-h_c
    u = jnp.einsum("im,lkmj->lkij", Qhz, u, precision=_HI)  # contract next-h_z
    u = jnp.einsum("jm,lkim->lkij", zP, u, precision=_HI)  # contract next-z
    return A2[None, :, None, None] * A3[None, None, :, :] * u


def T_ssy_factory(model: SSY,
                  disc: SSYDiscretization,
                  *,
                  space: str = "w",
                  baseline: Optional[str] = None,
                  dtype=None,
                  transcendentals: str = "accurate",
                  jit: bool = True) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Build the Koopmans operator T for the discretized SSY model.

    T(w) = 1 + beta * (H w^theta)^(1/theta) on the (l, k, i, j) tensor grid
    (reference ``ssy_wc_ratio.py:143-148``), computed by factored per-axis
    contractions.

    space="w":   T maps w -> T(w)                  (float64 parity path)
    space="log": T maps log w -> log T(w)          (float32-safe fast path)

    baseline="loglinear" (log space only) folds the separable log-linear
    closed-form approximation ell0 into the transition factors so the
    contraction runs on the residual theta*(ell - ell0) — required on wide
    grids where a single state axis carries more log-range than exp can
    represent (theta*Delta(ell) beyond ~87 in f32).  Exact algebra, better
    conditioning; iterate should start near the baseline (the returned T
    exposes ``T.baseline_log_w``).
    """
    if space not in ("w", "log"):
        raise ValueError(f"unknown space {space!r}")
    if baseline not in (None, "loglinear"):
        raise ValueError(f"unknown baseline {baseline!r}")
    if baseline and space != "log":
        raise ValueError("baseline normalization requires space='log'")
    if baseline:
        return _T_ssy_normalized(model, disc, dtype=dtype,
                                 transcendentals=transcendentals, jit=jit)
    beta, theta = model.beta, model.theta
    B_lam, A2, A3 = _ssy_factors(model, disc)
    Qc, Qhz, zP = disc.h_c_Q, disc.h_z_Q, disc.z_P
    if dtype is not None:
        B_lam, A2, A3, Qc, Qhz, zP = (a.astype(dtype)
                                      for a in (B_lam, A2, A3, Qc, Qhz, zP))

    if space == "w":
        def T(w):
            v = w ** theta
            hwt = _hw_theta_factored(v, B_lam, Qc, Qhz, zP, A2, A3)
            return 1.0 + beta * hwt ** (1.0 / theta)
    else:
        from functools import partial

        from ..ops.contract import lse_matmul
        lse = partial(lse_matmul, transcendentals=transcendentals)
        log_A2 = jnp.log(A2)
        log_A3 = jnp.log(A3)

        def T(ell):
            # Per-axis log-sum-exp contractions: exact for any dynamic
            # range of theta*ell (a single global shift overflows f32 on
            # wide Rouwenhorst grids — see ops/contract.py).
            a = theta * ell
            a = lse(B_lam, a, "lm,mkij->lkij", 0)
            a = lse(Qc, a, "km,lmij->lkij", 1)
            a = lse(Qhz, a, "im,lkmj->lkij", 2)
            a = lse(zP, a, "jm,lkim->lkij", 3)
            log_hwt = (a + log_A2[None, :, None, None]
                       + log_A3[None, None, :, :])
            return jnp.log1p(beta * jnp.exp(log_hwt / theta))

    return jax.jit(T) if jit else T


def dense_H_ssy(model: SSY, disc: SSYDiscretization) -> jnp.ndarray:
    """Materialize H as a dense (N, N) single-index matrix.

    Only for small grids: validates the factored contraction against a plain
    matmul ``1 + beta*(H @ w^theta)^(1/theta)`` (the reference keeps an
    equivalent legacy path for exactly this purpose,
    ``code/ssy/discrete/temp_ssy.py:49-159``).
    """
    B_lam, A2, A3 = _ssy_factors(model, disc)
    H8 = jnp.einsum("lL,kK,iI,jJ,k,ij->lkijLKIJ",
                    B_lam, disc.h_c_Q, disc.h_z_Q, disc.z_P, A2, A3)
    n = int(np.prod(disc.shapes))
    return H8.reshape(n, n)


def _ssy_normalized_arrays(model: SSY, disc: SSYDiscretization) -> dict:
    """Host-float64 assembly of the baseline-normalized operator factors.

    Shared by the XLA normalized operator (:func:`_T_ssy_normalized`) and
    the two-phase operand set (``operators/two_phase.py``).  Returns a
    dict of numpy arrays: folded transition factors M1 (l), M2 (k),
    M3 (j', i, i'), M4 (i, j, j'), the kappa terms log_A2 (k) and
    log_A3 (i, j), and the separable baseline components
    (A0, phi_l, phi_k, phi_i, psi_ij) with
    ell0 = A0 + phi_l ⊕ phi_k ⊕ (phi_i + psi_ij).
    """
    from ..models.ssy import ssy_loglinear_factory

    theta, gamma = model.theta, model.gamma

    ll = ssy_loglinear_factory(model)
    co = ll.coefficients
    h_lam = np.asarray(disc.h_lam_states, dtype=np.float64)
    h_c = np.asarray(disc.h_c_states, dtype=np.float64)
    h_z = np.asarray(disc.h_z_states, dtype=np.float64)
    z_states = np.asarray(disc.z_states, dtype=np.float64)

    # Separable baseline components (models/ssy.py wc_loglinear):
    phi_l = co["A_hlam"] * h_lam
    phi_k = co["A_hc"] * (h_c * 2 * model.phi_c**2 + model.phi_c**2)
    phi_i = co["A_hz"] * (h_z * 2 * model.phi_z**2 + model.phi_z**2)
    psi_ij = co["A_z"] * z_states                       # (i, j)

    # Folded factors, assembled in log space on host (full f64 range).
    def logQ(P):
        # Corner transition probabilities underflow even host f64 on very
        # wide chains; log(0) = -inf is the correct sentinel (exp restores
        # an exact 0 contribution).
        with np.errstate(divide="ignore"):
            return np.log(np.asarray(P, dtype=np.float64))
    B_log = logQ(disc.h_lam_Q) + theta * h_lam[None, :]   # A1 folded
    logM1 = B_log + theta * (phi_l[None, :] - phi_l[:, None])
    M1 = np.exp(logM1)
    logM2 = logQ(disc.h_c_Q) + theta * (phi_k[None, :] - phi_k[:, None])
    M2 = np.exp(logM2)
    # Step 3 (contract i' at fixed next-j axis): fold phi_i and the
    # (i', j')-coupled psi, rescaled by the current-(i, j') psi.
    # M3[j, i, ip] = Qhz[i, ip] * exp(theta*(phi_i[ip] - phi_i[i]
    #                                + psi[ip, j] - psi[i, j]))
    logM3 = (logQ(disc.h_z_Q)[None, :, :]
             + theta * (phi_i[None, None, :] - phi_i[None, :, None]
                        + psi_ij.T[:, None, :]
                        - psi_ij.T[:, :, None]))
    M3 = np.exp(logM3)
    # Step 4 (contract j' at fixed i): remaining telescope factor.
    # M4[i, j, jp] = zP[j, jp] * exp(theta*(psi[i, jp] - psi[i, j]))
    logM4 = (logQ(disc.z_P)[None, :, :]
             + theta * (psi_ij[:, None, :] - psi_ij[:, :, None]))
    M4 = np.exp(logM4)

    A2 = np.exp(0.5 * ((1 - gamma) * np.asarray(disc.sigma_c_states)) ** 2)
    log_A2 = np.log(A2)
    log_A3 = (1 - gamma) * (model.mu_c + z_states)

    return dict(M1=M1, M2=M2, M3=M3, M4=M4, log_A2=log_A2, log_A3=log_A3,
                logM1=logM1, logM2=logM2, logM3=logM3, logM4=logM4,
                A0=float(co["A0"]), phi_l=phi_l, phi_k=phi_k, phi_i=phi_i,
                psi_ij=psi_ij, A_z=float(co["A_z"]))


def _T_ssy_normalized(model: SSY, disc: SSYDiscretization, *, dtype=None,
                      transcendentals: str = "accurate", jit: bool = True):
    """Log-space operator with the log-linear baseline folded in.

    With ell0 the (separable) log-linear approximation of log w*, the
    folded kernel H~(x, x') = H(x, x') * exp(theta*(ell0(x') - ell0(x)))
    satisfies  sum_x' H~(x,x') e^{theta*delta(x')} = e^{-theta*ell0(x)} *
    (H w^theta)(x)  for delta = ell - ell0.  ell0's per-axis components
    distribute into the per-axis factors (the z-component, coupled in
    (i, j), rides the z contraction exactly like the state-dependent z_Q),
    telescoping exactly — no approximation, only reconditioning: every
    intermediate is O(e^{theta*delta}), so wide grids stay inside f32
    range.  Matrices are assembled in host float64 (full exponent range)
    and cast.
    """
    from functools import partial

    from ..ops.contract import lse_matmul, normalize_rows_log

    theta, beta = model.theta, model.beta
    # dtype=None means keep float64 (every other operator path's
    # convention); the f32 scale tier is an explicit request.
    work_dtype = dtype or jnp.float64
    # f32: same recipe as the GCY normalized tier — construction-time
    # log-domain row normalization (the folded factors reach
    # e^{+-hundreds} on wide-Rouwenhorst ladders, so a plain f32 cast
    # makes inf/0 entries) + the deep second matmul window (localized
    # ladder-corner rows sit up to ~theta*4.4 ~ -167 nats below the
    # slice max, past the single ~87-nat window).
    lse = partial(lse_matmul, transcendentals=transcendentals,
                  deep_window=80.0 if work_dtype == jnp.float32 else 0.0,
                  deep_passes=3)

    arrs = _ssy_normalized_arrays(model, disc)
    log_A2, log_A3 = arrs["log_A2"], arrs["log_A3"]
    phi_l, phi_k = arrs["phi_l"], arrs["phi_k"]
    ell0 = (arrs["A0"] + phi_l[:, None, None, None]
            + phi_k[None, :, None, None]
            + arrs["phi_i"][None, None, :, None]
            + arrs["psi_ij"][None, None, :, :])

    SUBS = ("lm,mkij->lkij", "km,lmij->lkij",
            "jim,lkmj->lkij", "ijm,lkim->lkij")
    AXES = (0, 1, 2, 3)
    Ms, log_ss = [], []
    for key, subs, ax in zip(("logM1", "logM2", "logM3", "logM4"),
                             SUBS, AXES):
        Mn, ls = normalize_rows_log(arrs[key], subs, ax)
        Ms.append(Mn)
        log_ss.append(ls)

    cast = lambda a: jnp.asarray(a, dtype=work_dtype)
    Ms = [cast(M) for M in Ms]
    log_ss = [cast(ls) for ls in log_ss]
    ell0_j = cast(ell0)
    log_A2 = cast(log_A2)
    log_A3 = cast(log_A3)
    theta_c = jnp.asarray(theta, work_dtype)

    def T(ell):
        a = theta_c * (ell - ell0_j)
        for M, ls, subs, ax in zip(Ms, log_ss, SUBS, AXES):
            a = lse(M, a, subs, ax) + ls
        log_hwt = (theta_c * ell0_j + a
                   + log_A2[None, :, None, None]
                   + log_A3[None, None, :, :])
        return jnp.log1p(beta * jnp.exp(log_hwt / theta_c))

    T = jax.jit(T) if jit else T
    T.baseline_log_w = ell0_j
    return T
