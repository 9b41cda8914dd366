"""de Groot-style recursive utility: the alternative specification.

The reference's companion paper (``paper/temp.tex:1421-1516``) analyzes
the de Groot (2018) / de Groot-Richter-Vyshnevskyi (2021) aggregator,
which removes the preference-shock asymptote by moving the shocks into a
*state-dependent discount factor* ``a_t = h(X_t)``:

    V = [ (1 - a beta) C^(1-1/psi)
          + a beta { R_{1-gamma}(V') }^(1-1/psi) ]^(1/(1-1/psi)).

With ``g := (V/C)^(1-gamma)`` the stationary Markov solution solves the
fixed point (``temp.tex:1440-1482``)

    g(x) = (T~ g)(x) = ( 1 - h(x) beta
                         + h(x) beta * (K~ g)(x)^(1/theta) )^theta,

    (K~ g)(x) = E_x[ g(X') exp((1-gamma) g_c) ],

where ``K~`` is the SAME factored per-axis contraction chain as the
standard Koopmans operator with the preference-shock tilt REMOVED (plain
``Q_lam`` in place of ``B_lam``); only the A2/A3 consumption tilt
remains.  Existence/uniqueness (``temp.tex:1484-1508``, Proposition
p:drt): ``S~ = ln beta + ln sup h + ln r(K~)/theta < 0`` — notably free
of the preference-shock growth rate, which is exactly the paper's point
about the asymptote.

Exact cross-check used by the tests: at ``h == 1`` the recursion is the
standard EZ aggregator with the (1 - beta) weight kept explicit, so with
the lambda-tilt absent (s_lam = 0) the solution maps to the standard
fixed point in closed form: ``u := g^(1/theta)`` satisfies
``u = (1-beta) + beta (K~ u^theta)^(1/theta)``, and scaling by the
degree-1 homogeneity of ``t -> (K~ t^theta)^(1/theta)`` gives
``g* = ((1 - beta) * w*)^theta``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from ..models.gcy import GCY
from ..models.ssy import SSY

# Keep float32 operands in float32 on the GPU (its default is TF32, which
# keeps about three digits); a no-op for float64.
_HI = jax.lax.Precision.HIGHEST

__all__ = ["T_degroot_factory", "T_degroot_continuous_factory",
           "existence_check_degroot"]


def _K_tilde(model, disc, transcendentals: str = "accurate", dtype=None):
    """The untilted-lambda expectation chain K~ and the grid shape.

    Returns ``(apply_K, apply_K_log, shapes)``: the w-space chain and its
    per-axis log-sum-exp twin ``ln K~ exp(ell)`` — the same per-axis-shift
    structure as the standard log-space operators (a single global shift
    overflows f32 on wide grids; ``ops/contract.py``).
    """
    from functools import partial

    from ..ops.contract import lse_matmul
    lse = partial(lse_matmul, transcendentals=transcendentals)

    if isinstance(model, SSY):
        from .discrete_ssy import _hw_theta_factored, _ssy_factors
        _, A2, A3 = _ssy_factors(model, disc)
        Ql, Qc, Qhz, zP = (disc.h_lam_Q, disc.h_c_Q, disc.h_z_Q, disc.z_P)
        log_A2, log_A3 = jnp.log(A2), jnp.log(A3)
        if dtype is not None:
            Ql, Qc, Qhz, zP, A2, A3, log_A2, log_A3 = (
                a.astype(dtype) for a in (Ql, Qc, Qhz, zP, A2, A3,
                                          log_A2, log_A3))

        def apply_K(v):                        # v: (l, k, i, j)
            # the canonical chain with plain Q_lam in place of B_lam
            return _hw_theta_factored(v, Ql, Qc, Qhz, zP, A2, A3)

        def apply_K_log(a):                    # a = ln g
            a = lse(Ql, a, "lm,mkij->lkij", 0)
            a = lse(Qc, a, "km,lmij->lkij", 1)
            a = lse(Qhz, a, "im,lkmj->lkij", 2)
            a = lse(zP, a, "jm,lkim->lkij", 3)
            return (a + log_A2[None, :, None, None]
                    + log_A3[None, None, :, :])

        return apply_K, apply_K_log, disc.shapes
    if isinstance(model, GCY):
        from .discrete_gcy import _gcy_factors
        _, A2, A3 = _gcy_factors(model, disc)
        log_A2, log_A3 = jnp.log(A2), jnp.log(A3)
        Ql, Qc, Qhz, Qhzpi = (disc.h_lam_Q, disc.h_c_Q, disc.h_z_Q,
                              disc.h_zpi_Q)
        zpiP, zP = disc.z_pi_P, disc.z_P
        if dtype is not None:
            (Ql, Qc, Qhz, Qhzpi, zpiP, zP, A2, A3, log_A2, log_A3) = (
                a.astype(dtype) for a in (Ql, Qc, Qhz, Qhzpi, zpiP, zP,
                                          A2, A3, log_A2, log_A3))

        def apply_K(v):                        # v: (z, z_pi, h_z, h_c, h_zpi, h_lam)
            u = jnp.einsum("lL,ABCDEL->ABCDEl", Ql, v, precision=_HI)
            u = jnp.einsum("dD,ABCDEl->ABCdEl", Qc, u, precision=_HI)
            u = jnp.einsum("cC,ABCdEl->ABcdEl", Qhz, u, precision=_HI)
            u = jnp.einsum("eE,ABcdEl->ABcdel", Qhzpi, u, precision=_HI)
            u = jnp.einsum("bB,ABcdel->Abcdel", zpiP, u, precision=_HI)
            u = jnp.einsum("aA,Abcdel->abcdel", zP, u, precision=_HI)
            return (A2[None, None, None, :, None, None]
                    * A3[:, :, :, None, :, None] * u)

        def apply_K_log(a):
            a = lse(Ql, a, "lL,ABCDEL->ABCDEl", 5)
            a = lse(Qc, a, "dD,ABCDEl->ABCdEl", 3)
            a = lse(Qhz, a, "cC,ABCdEl->ABcdEl", 2)
            a = lse(Qhzpi, a, "eE,ABcdEl->ABcdel", 4)
            a = lse(zpiP, a, "bB,ABcdel->Abcdel", 1)
            a = lse(zP, a, "aA,Abcdel->abcdel", 0)
            return (a + log_A2[None, None, None, :, None, None]
                    + log_A3[:, :, :, None, :, None])

        return apply_K, apply_K_log, disc.shapes
    raise TypeError(f"unsupported model {type(model).__name__}")


def _degroot_T(model, h, space, dtype, apply_K, apply_K_log, shapes,
               jit):
    """The de Groot outer map over a prepared K~ chain (shared by the
    discrete and continuous factories)."""
    if space not in ("w", "log"):
        raise ValueError(f"unknown space {space!r}")
    theta, beta = model.theta, model.beta
    wdtype = dtype or jnp.float64
    theta_c = jnp.asarray(theta, wdtype)
    hb = _h_array(h, shapes, beta, wdtype) * beta

    if space == "w":
        def T(g):
            k = apply_K(g)
            return (1.0 - hb + hb * k ** (1.0 / theta)) ** theta
    else:
        def T(ell):
            k_log = apply_K_log(ell)
            return theta_c * jnp.log(1.0 - hb
                                     + hb * jnp.exp(k_log / theta_c))

    return jax.jit(T) if jit else T


def _h_array(h, shapes, beta, dtype):
    if h is None:
        h = 1.0
    h = jnp.broadcast_to(jnp.asarray(h, dtype), shapes)
    hmax = float(jnp.max(h))
    if hmax * beta >= 1.0 or float(jnp.min(h)) <= 0.0:
        raise ValueError(
            f"h must take values in (0, 1/beta) = (0, {1/beta:.6f}); "
            f"got range [{float(jnp.min(h)):.6f}, {hmax:.6f}]")
    return h


def T_degroot_factory(model, disc, *, h=None, space: str = "w",
                      dtype=None, transcendentals: str = "accurate",
                      jit: bool = True
                      ) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Build the de Groot fixed-point operator T~ on the discretized grid.

    ``h``: None (constant discount a = 1, the de Groot 2018 case), a
    scalar, or an array over the grid (state-dependent discounting —
    how this specification carries preference shocks); values must lie
    in ``(0, 1/beta)``.

    ``space="w"`` iterates on g directly (f64 parity tier);
    ``space="log"`` on ln g with the expectation chain contracted by
    per-axis log-sum-exp shifts (the f32-safe tier, the same
    per-axis LSE structure as the standard operators — exact for any
    dynamic range of ln g, which reaches ~e^100 scales at production
    calibrations; docs/math.md §9).
    """
    apply_K, apply_K_log, shapes = _K_tilde(model, disc, transcendentals,
                                            dtype)
    return _degroot_T(model, h, space, dtype, apply_K, apply_K_log,
                      shapes, jit)


@dataclasses.dataclass
class DeGrootExistenceReport:
    spectral_radius: float          # r(K~)
    S_alt: float                    # ln beta + ln sup h + ln r(K~)/theta
    exists_unique: bool
    iterations: int

    def __repr__(self):
        return (f"DeGrootExistenceReport(r(K~)={self.spectral_radius:.6g}, "
                f"S_alt={self.S_alt:.6f}, "
                f"exists_unique={self.exists_unique})")


def existence_check_degroot(model, disc=None, *, grids=None,
                            quad_degree: int = 5, h=None,
                            tol: float = 1e-10) -> DeGrootExistenceReport:
    """Proposition p:drt's condition (``temp.tex:1484-1508``):
    S~ = ln beta + ln(sup h) + ln r(K~)/theta < 0.  Unlike the standard
    condition, the preference-shock *growth rate* never enters — only
    the discount's maximum level.

    Pass ``disc`` for the discretized chain or ``grids`` (+
    ``quad_degree``) for the continuous quadrature chain — the same
    dual surface as :func:`~..utils.spectral.existence_check`.
    """
    import numpy as np

    from ..utils.spectral import power_iteration

    if (disc is None) == (grids is None):
        raise ValueError("pass exactly one of disc or grids")
    if grids is not None:
        apply_K, _, shapes = _K_tilde_continuous(model, grids, quad_degree)
    else:
        apply_K, _, shapes = _K_tilde(model, disc)
    a_bar = 1.0 if h is None else float(jnp.max(jnp.asarray(h)))
    r, it = jax.jit(lambda: power_iteration(apply_K, shapes, tol=tol))()
    S_alt = (float(np.log(model.beta)) + float(np.log(a_bar))
             + float(np.log(r)) / model.theta)
    return DeGrootExistenceReport(spectral_radius=float(r), S_alt=S_alt,
                                  exists_unique=bool(S_alt < 0),
                                  iterations=int(it))


def _K_tilde_continuous(model, grids, degree,
                        transcendentals: str = "accurate", dtype=None):
    """Continuous (quadrature + interp="pre") untilted-lambda chain.

    Same ``(apply_K, apply_K_log, shapes)`` contract as :func:`_K_tilde`.
    """
    from functools import partial

    from ..ops.contract import lse_matmul
    lse = partial(lse_matmul, transcendentals=transcendentals)

    if isinstance(model, SSY):
        from .continuous_ssy import _factored_arrays_ssy
        arrs = _factored_arrays_ssy(model, grids, degree, None,
                                    tilt_lambda=False)
        P_lam, P_c, P_hz, P_z = (arrs["P_lam"], arrs["P_c"], arrs["P_hz"],
                                 arrs["P_z"])
        log_A2, log_A3 = arrs["log_A2"], arrs["log_A3"]
        if dtype is not None:
            P_lam, P_c, P_hz, P_z, log_A2, log_A3 = (
                a.astype(dtype) for a in (P_lam, P_c, P_hz, P_z,
                                          log_A2, log_A3))
        kappa = jnp.exp(log_A2[:, None] + log_A3[None, :])

        def apply_K(g):                        # g: (l, k, i, j)
            u = jnp.einsum("lL,LKIJ->lKIJ", P_lam, g, precision=_HI)
            u = jnp.einsum("kK,lKIJ->lkIJ", P_c, u, precision=_HI)
            u = jnp.einsum("iI,lkIJ->lkiJ", P_hz, u, precision=_HI)
            u = jnp.einsum("ijJ,lkiJ->lkij", P_z, u, precision=_HI)
            return kappa[None, :, None, :] * u

        def apply_K_log(a):                    # a = ln g
            a = lse(P_lam, a, "lL,LKIJ->lKIJ", 0)
            a = lse(P_c, a, "kK,lKIJ->lkIJ", 1)
            a = lse(P_hz, a, "iI,lkIJ->lkiJ", 2)
            a = lse(P_z, a, "ijJ,lkiJ->lkij", 3)
            return (a + log_A2[None, :, None, None]
                    + log_A3[None, None, None, :])

        return apply_K, apply_K_log, tuple(len(g) for g in grids)
    if isinstance(model, GCY):
        from .continuous_gcy import _factored_arrays_gcy
        arrs = _factored_arrays_gcy(model, grids, degree, None,
                                    tilt_lambda=False)
        P_lam, P_c, P_hz, P_hzpi, P_zpi, P_z = (
            arrs["P_lam"], arrs["P_c"], arrs["P_hz"], arrs["P_hzpi"],
            arrs["P_zpi"], arrs["P_z"])
        log_A2, log_A3 = arrs["log_A2"], arrs["log_A3"]
        if dtype is not None:
            (P_lam, P_c, P_hz, P_hzpi, P_zpi, P_z, log_A2, log_A3) = (
                a.astype(dtype) for a in (P_lam, P_c, P_hz, P_hzpi,
                                          P_zpi, P_z, log_A2, log_A3))
        kappa = jnp.exp(log_A2[:, None] + log_A3[None, :])

        def apply_K(g):                        # g: (l, k, i, y, j, b)
            u = jnp.einsum("lL,LKIYJB->lKIYJB", P_lam, g, precision=_HI)
            u = jnp.einsum("kK,lKIYJB->lkIYJB", P_c, u, precision=_HI)
            u = jnp.einsum("iI,lkIYJB->lkiYJB", P_hz, u, precision=_HI)
            u = jnp.einsum("yY,lkiYJB->lkiyJB", P_hzpi, u, precision=_HI)
            u = jnp.einsum("ybB,lkiyJB->lkiyJb", P_zpi, u, precision=_HI)
            u = jnp.einsum("ijbJ,lkiyJb->lkiyjb", P_z, u, precision=_HI)
            return kappa[None, :, None, None, :, None] * u

        def apply_K_log(a):
            a = lse(P_lam, a, "lL,LKIYJB->lKIYJB", 0)
            a = lse(P_c, a, "kK,lKIYJB->lkIYJB", 1)
            a = lse(P_hz, a, "iI,lkIYJB->lkiYJB", 2)
            a = lse(P_hzpi, a, "yY,lkiYJB->lkiyJB", 3)
            a = lse(P_zpi, a, "ybB,lkiyJB->lkiyJb", 5)
            a = lse(P_z, a, "ijbJ,lkiyJb->lkiyjb", 4)
            return (a + log_A2[None, :, None, None, None, None]
                    + log_A3[None, None, None, None, :, None])

        return apply_K, apply_K_log, tuple(len(g) for g in grids)
    raise TypeError(f"unsupported model {type(model).__name__}")


def T_degroot_continuous_factory(model, grids, *, h=None,
                                 quad_degree: int = 5, space: str = "w",
                                 dtype=None,
                                 transcendentals: str = "accurate",
                                 jit: bool = True
                                 ) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Continuous-state T~ on uniform grids (quadrature + interp="pre"),
    mirroring :func:`T_degroot_factory`'s semantics: the factored
    per-dimension Gauss-Hermite expectation chain with the lambda tilt
    removed, then the de Groot outer map with discount field ``h``
    (None | scalar | array over the grid, values in (0, 1/beta)).
    ``space="log"`` contracts by per-axis log-sum-exp (f32-safe tier)."""
    apply_K, apply_K_log, shapes = _K_tilde_continuous(
        model, grids, quad_degree, transcendentals, dtype)
    return _degroot_T(model, h, space, dtype, apply_K, apply_K_log,
                      shapes, jit)
