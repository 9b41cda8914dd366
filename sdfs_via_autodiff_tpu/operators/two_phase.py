"""Two-phase (column-group / row-group) form of the 4-D log-space operators.

Every 4-D Koopmans operator in this package — discrete SSY (plain and
baseline-normalized) and continuous-SSY factored-quadrature (plain and
normalized) — is a chain of four per-axis log-sum-exp contractions plus a
separable epilogue.  Grouping the four state axes as rows (h_lam, h_c) and
columns (h_z, z) of a matrix view splits the chain into

    column phase:  contract next-h_z, then next-z      (touches only columns)
    row phase:     contract next-h_lam, then next-h_c  (touches only rows)

with the epilogue's additive terms separable into a row part and a column
part.  This module holds the grouping (:class:`TwoPhaseOperands`), builders
that assemble it for each operator instance, and a plain-XLA evaluator
(:func:`make_xla_two_phase_T`).  The point of the grouping: each phase
needs only a strip of the field (all columns of a few rows, or all rows of
a few columns), so a fused kernel could run the whole operator in two
memory-minimal passes — one read and one write of the field per phase —
instead of the ~10 passes of the unfused per-axis einsum chain.

Reference semantics covered: discrete ``T_ssy`` (``/root/reference/code/
ssy/discrete/ssy_wc_ratio.py:82-151``) and the quadrature continuous
operator (``.../ssy_wc_ratio_continuous.py:125-153``), both in the exact
factored reformulation documented in ``operators/discrete_ssy.py`` /
``operators/continuous_common.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["TwoPhaseOperands", "two_phase_operands_ssy",
           "two_phase_operands_ssy_continuous", "two_phase_operands_gcy",
           "two_phase_operands_gcy_continuous", "make_xla_two_phase_T"]


@dataclasses.dataclass(frozen=True)
class TwoPhaseOperands:
    """Operands of a two-phase 4-D log-space operator.

    Field layout: ell[r1, r2, c1, c2] with rows (r1, r2) and columns
    (c1, c2).  The operator is

        a   = theta*ell - sub_row ⊕ sub_col                (sub_* optional)
        a   = LSE-contract axis c1 with W_c1               (column phase)
        a   = LSE-contract axis c2 with W_c2
        a   = LSE-contract axis r1 with W_r1               (row phase)
        a   = LSE-contract axis r2 with W_r2
        out = log1p(beta * exp((a + add_row ⊕ add_col) / theta))

    ``W_c1`` is (n_c1, n_c1), or (n_c2, n_c1, n_c1) batched over the *next*
    c2 index (it applies before c2 is contracted); ``W_c2`` is
    (n_c2, n_c2), or (n_c1, n_c2, n_c2) batched over the *current* c1
    index.  All arrays are host float64 (full exponent range); the
    evaluator casts.
    """

    shapes: Tuple[int, int, int, int]
    W_r1: np.ndarray
    W_r2: np.ndarray
    W_c1: np.ndarray
    W_c2: np.ndarray
    add_row: np.ndarray                 # (n_r1, n_r2)
    add_col: np.ndarray                 # (n_c1, n_c2)
    theta: float
    beta: float
    sub_row: Optional[np.ndarray] = None   # (n_r1, n_r2), theta*ell0 row part
    sub_col: Optional[np.ndarray] = None   # (n_c1, n_c2), theta*ell0 col part
    baseline_log_w: Optional[np.ndarray] = None  # full 4-D ell0

    @property
    def c1_batched(self) -> bool:
        return self.W_c1.ndim == 3

    @property
    def c2_batched(self) -> bool:
        return self.W_c2.ndim == 3

    @property
    def has_sub(self) -> bool:
        return self.sub_row is not None


def _kron(X, Y):
    """Dense Kronecker product (row-major pairing) in float64."""
    return np.einsum("aA,bB->abAB", np.asarray(X, np.float64),
                     np.asarray(Y, np.float64)).reshape(
        X.shape[0] * Y.shape[0], X.shape[1] * Y.shape[1])


def _warn_ssy_f32_envelope(model, disc) -> None:
    """Warn when theta * (within-column-group log-w span) exceeds exp's
    f32 range for the plain SSY operands (the GCY builder's guard,
    specialized: the SSY log-linear solution's (h_z, z) part is separable
    from the rows, so the span is exact and row-independent)."""
    import warnings

    from ..models.ssy import ssy_loglinear_factory

    co = ssy_loglinear_factory(model).coefficients
    h_z = np.asarray(disc.h_z_states, np.float64)
    phi_i = co["A_hz"] * (h_z * 2 * model.phi_z**2 + model.phi_z**2)
    psi_ij = co["A_z"] * np.asarray(disc.z_states, np.float64)   # (i, j)
    col = phi_i[:, None] + psi_ij
    span = float(col.max() - col.min())
    if abs(model.theta) * span > 85.0:
        warnings.warn(
            f"theta * (within-column-group log-w span) ~ "
            f"{abs(model.theta) * span:.0f} exceeds float32's exp range "
            "(~85): the f32 two-phase SSY operator will produce -inf/NaN on "
            "this grid (its joint column-group shifts cannot window per "
            "row). Use the XLA normalized tier — T_ssy_factory(space="
            "'log', baseline='loglinear', dtype=float32), whose "
            "log-domain row normalization + deep matmul window cover "
            "wide ladders — shrink the z / h_z axes (Rouwenhorst spans "
            "grow like sqrt(n)), use discretization='tauchen', or the "
            "float64 XLA chain.",
            stacklevel=3)


def two_phase_operands_ssy(model, disc, baseline: Optional[str] = None
                           ) -> TwoPhaseOperands:
    """Two-phase operands for the discrete SSY operator.

    ``baseline=None`` groups the plain factors (B_lam, Q_c | Q_hz, z_P);
    ``baseline="loglinear"`` groups the folded factors M1..M4 of the
    normalized operator (``discrete_ssy._ssy_normalized_arrays``).
    """
    from .discrete_ssy import _ssy_factors, _ssy_normalized_arrays

    n_l, n_k, n_i, n_j = disc.shapes
    theta, beta = model.theta, model.beta
    if baseline is None:
        B_lam, A2, A3 = _ssy_factors(model, disc)
        add_row = np.broadcast_to(
            np.log(np.asarray(A2, np.float64))[None, :], (n_l, n_k)).copy()
        add_col = np.log(np.asarray(A3, np.float64))
        # f32 range guard, mirroring the GCY builder's: the column phase
        # shifts over the joint (h_z, z) group, so if theta * (log-w span
        # within a column group) exceeds exp's f32 range, whole rows
        # underflow to exact zero -> -inf/NaN after one application.
        # The log-linear solution is the span proxy (its column part is
        # separable from the rows, so the span is row-independent).
        _warn_ssy_f32_envelope(model, disc)
        return TwoPhaseOperands(
            shapes=disc.shapes,
            W_r1=np.asarray(B_lam, np.float64),
            W_r2=np.asarray(disc.h_c_Q, np.float64),
            W_c1=np.asarray(disc.h_z_Q, np.float64),
            W_c2=np.asarray(disc.z_P, np.float64),
            add_row=add_row, add_col=add_col, theta=theta, beta=beta)
    if baseline != "loglinear":
        raise ValueError(f"unknown baseline {baseline!r}")
    arrs = _ssy_normalized_arrays(model, disc)
    # f32 range guard for the *normalized* operator: the baseline fold
    # moves the range pressure into the folded factors M3/M4, whose
    # entries carry exp(theta * Delta psi) weights.  Corner-probability
    # *underflow* (log-0 entries) is benign — those contributions are
    # genuinely negligible — but large positive entries eat the exp-range
    # headroom the LSE accumulations and the iterate's residual
    # theta*(ell - ell0) need: the NaN NORTHSTAR config (32,32,32,384)
    # measures log max(M3) ~ 69 (19 log units of headroom, and the
    # log-linear baseline is itself ~4.4 log units off at those corners,
    # so theta*residual ~ 70 overflows after one iteration), while known-
    # good wide grids measure <= ~22.  Warn above 45 — roughly half the
    # f32 exp range left as headroom.
    import warnings
    fac_max = max(float(np.log(arrs["M3"].max())),
                  float(np.log(arrs["M4"].max())))
    if fac_max > 45.0:
        warnings.warn(
            f"normalized-operator folded factors reach e^{fac_max:.0f}, "
            "leaving too little float32 exp-range headroom for the "
            "iterate's residual: the f32 two-phase SSY operator is likely to "
            "produce inf/NaN on this grid. Shrink the z / h_z axes "
            "(Rouwenhorst ladders span ±sqrt(n-1) sigma), use "
            "discretization='tauchen' (fixed ±3 sigma span at any point "
            "count), or the float64 XLA chain.", stacklevel=2)
    sub_row = theta * (arrs["phi_l"][:, None] + arrs["phi_k"][None, :])
    sub_col = theta * (arrs["A0"] + arrs["phi_i"][:, None] + arrs["psi_ij"])
    ell0 = (arrs["A0"] + arrs["phi_l"][:, None, None, None]
            + arrs["phi_k"][None, :, None, None]
            + arrs["phi_i"][None, None, :, None]
            + arrs["psi_ij"][None, None, :, :])
    ops = TwoPhaseOperands(
        shapes=disc.shapes,
        W_r1=arrs["M1"], W_r2=arrs["M2"], W_c1=arrs["M3"], W_c2=arrs["M4"],
        add_row=sub_row + arrs["log_A2"][None, :],
        add_col=sub_col + arrs["log_A3"],
        theta=theta, beta=beta,
        sub_row=sub_row, sub_col=sub_col, baseline_log_w=ell0)
    return ops


def two_phase_operands_ssy_continuous(model, grids, degree: int = 5,
                                      baseline=None) -> TwoPhaseOperands:
    """Two-phase operands for the continuous factored-quadrature SSY
    operator (interp="pre"); optional separable baseline (see
    ``continuous_ssy._factored_arrays_ssy``)."""
    from .continuous_ssy import _factored_arrays_ssy

    shapes = tuple(len(g) for g in grids)
    n_l, n_k, n_i, n_j = shapes
    theta, beta = model.theta, model.beta
    arrs = _factored_arrays_ssy(model, grids, degree, baseline)
    log_A2 = np.asarray(arrs["log_A2"], np.float64)           # (k,)
    log_A3 = np.asarray(arrs["log_A3"], np.float64)           # (j,)
    add_row = np.broadcast_to(log_A2[None, :], (n_l, n_k)).copy()
    add_col = np.broadcast_to(log_A3[None, :], (n_i, n_j)).copy()
    sub_row = sub_col = ell0 = None
    if arrs["ell0_parts"] is not None:
        const0, phi_l, phi_k, phi_i, phi_j = arrs["ell0_parts"]
        sub_row = theta * (phi_l[:, None] + phi_k[None, :])
        sub_col = theta * (const0 + phi_i[:, None] + phi_j[None, :])
        add_row = add_row + sub_row
        add_col = add_col + sub_col
        ell0 = (const0 + phi_l[:, None, None, None]
                + phi_k[None, :, None, None]
                + phi_i[None, None, :, None] + phi_j[None, None, None, :])
    return TwoPhaseOperands(
        shapes=shapes,
        W_r1=np.asarray(arrs["P_lam"], np.float64),
        W_r2=np.asarray(arrs["P_c"], np.float64),
        W_c1=np.asarray(arrs["P_hz"], np.float64),
        W_c2=np.asarray(arrs["P_z"], np.float64),     # (i, j, j') batched
        add_row=add_row, add_col=add_col, theta=theta, beta=beta,
        sub_row=sub_row, sub_col=sub_col, baseline_log_w=ell0)


def two_phase_operands_gcy_continuous(model, grids, degree: int = 5,
                                      baseline=None) -> TwoPhaseOperands:
    """Two-phase operands for the *continuous six-state GCY* factored-
    quadrature operator (interp="pre"; reference semantics
    ``/root/reference/code/gcy/continuous/gcy_wc_ratio_continuous.py:
    158-187``).

    Grouping (view layout ``ell[k, l, (i, y), (b, j)]``, natural order
    (l, k, i, y, j, b) carried by ``ops.perm``/``ops.inv_perm``):

        rows:    r1 = h_c  (k)          W_r1 = P_c
                 r2 = h_lam (l)         W_r2 = P_lam (payoff folded)
        columns: c1 = (h_z (x) h_zpi)   W_c1 = P_hz (x) P_hzpi  (shared)
                 c2 = (z_pi, z), z minor

    Unlike the discrete GCY Kronecker fold, the continuous z/z_pi
    expectation matrices are *truly conditioned* — P_zpi on the current
    h_zpi (y) and P_z on the current h_z (i) AND current z_pi (b): the
    conditioning changes the quadrature-interpolation geometry, so no
    shared-factor conjugation exists.  The joint c2 factor batched over
    the current c1 slice,

        W_c2[(i, y)][(b, j), (B, J)] = P_zpi[y, b, B] * P_z[i, j, b, J],

    is exact (contracting next-B then next-J per the chain order equals
    the joint product because P_z's z_pi conditioning is on the CURRENT
    b — a row index of the joint matrix).  It is never materialized:
    ``ops.pair_c2 = (P_z, P_zpi)`` (+ ``ops.pair_shapes``) carries the
    per-axis factors, which the plain evaluator contracts as the factored
    per-axis chain.  ``W_c2``
    itself is a broadcast placeholder (shape/ndim carrier only).

    ``baseline`` is "loglinear" or an ``(const, profiles)`` pair from
    ``drivers.additive_profiles`` — effectively required for float32
    (GCY's theta = -36 puts theta*(log-w range) ~ 200 on reference-style
    grids); the fold is separable so sub/add split row/column exactly.
    """
    from .continuous_gcy import _factored_arrays_gcy

    n_l, n_k, n_i, n_y, n_j, n_b = (len(g) for g in grids)
    IY, C2 = n_i * n_y, n_b * n_j
    theta, beta = float(model.theta), float(model.beta)
    arrs = _factored_arrays_gcy(model, grids, degree, baseline)
    W_c1 = _kron(arrs["P_hz"], arrs["P_hzpi"])
    P_z = np.asarray(arrs["P_z"], np.float64)        # (i, j, b, J)
    P_zpi = np.asarray(arrs["P_zpi"], np.float64)    # (y, b, B)
    # Row-normalize P_zpi, moving log(rowsum) into the log-domain
    # per-column add below.  The raw rows carry folded payoff factors
    # that sum to ~e^38 on reference calibrations, which (a) wastes
    # most of the linear chain's f32 window on a constant scale and
    # (b) made a single-shift exponent bias overflow (NaNs).  A
    # per-(y, b) scale rides the b lane through the row carries — the
    # carries contract rows, never columns — so the move is exact.
    zpi_scale = P_zpi.sum(axis=2)                    # (y, b)
    P_zpi = P_zpi / np.where(zpi_scale == 0.0, 1.0, zpi_scale)[:, :, None]
    with np.errstate(divide="ignore"):               # 0-mass row -> -inf
        log_zpi_scale = np.log(zpi_scale)
    log_A2 = np.asarray(arrs["log_A2"], np.float64)  # (k,)
    log_A3 = np.asarray(arrs["log_A3"], np.float64)  # (j,)
    add_row = np.broadcast_to(log_A2[:, None], (n_k, n_l)).copy()
    colpart = np.broadcast_to(log_A3[None, :], (n_b, n_j)).reshape(C2)
    add_col = np.broadcast_to(colpart[None, :], (IY, C2)).copy()
    add_col += np.tile(
        np.broadcast_to(log_zpi_scale[:, :, None],
                        (n_y, n_b, n_j)).reshape(n_y, C2), (n_i, 1))
    sub_row = sub_col = ell0 = None
    if arrs["ell0_parts"] is not None:
        const0, phi_l, phi_k, phi_i, phi_y, phi_j, phi_b = (
            np.asarray(p, np.float64) if not np.isscalar(p) else p
            for p in arrs["ell0_parts"])
        phi_iy = (phi_i[:, None] + phi_y[None, :]).reshape(IY)
        phi_bj = (phi_b[:, None] + phi_j[None, :]).reshape(C2)
        sub_row = theta * (phi_k[:, None] + phi_l[None, :])
        sub_col = theta * (const0 + phi_iy[:, None] + phi_bj[None, :])
        add_row = add_row + sub_row
        add_col = add_col + sub_col
        ell0 = (const0 + phi_k[:, None, None, None]
                + phi_l[None, :, None, None]
                + phi_iy[None, None, :, None] + phi_bj[None, None, None, :])
    ops = TwoPhaseOperands(
        shapes=(n_k, n_l, IY, C2),
        W_r1=np.asarray(arrs["P_c"], np.float64),
        W_r2=np.asarray(arrs["P_lam"], np.float64),
        W_c1=W_c1,
        # Placeholder (ndim-3 so c2_batched reports the truth); the pair
        # factors below are the real operand.
        W_c2=np.broadcast_to(np.zeros((C2, C2)), (IY, C2, C2)),
        add_row=add_row, add_col=add_col, theta=theta, beta=beta,
        sub_row=sub_row, sub_col=sub_col, baseline_log_w=ell0)
    object.__setattr__(ops, "pair_c2", (P_z, P_zpi))
    object.__setattr__(ops, "pair_shapes", (n_i, n_y, n_b, n_j))
    # Natural (l, k, i, y, j, b) -> view (k, l, i, y, b, j); self-inverse.
    object.__setattr__(ops, "perm", (1, 0, 2, 3, 5, 4))
    object.__setattr__(ops, "inv_perm", (1, 0, 2, 3, 5, 4))
    object.__setattr__(ops, "state_shapes",
                       (n_l, n_k, n_i, n_y, n_j, n_b))
    return ops


def two_phase_operands_gcy(model, disc, baseline: Optional[str] = None
                           ) -> TwoPhaseOperands:
    """Two-phase operands for the *discrete six-state GCY* operator via
    Kronecker grouping.

    The discrete GCY transitions all use shared per-axis matrices (the
    conditioning of the z_pi and z chains lives entirely in the state
    ladders, ``discrete_gcy.discretize_gcy``), so the six-axis chain
    folds exactly into a 4-D two-phase operand set:

        rows:    r1 = h_c               W_r1 = Qc
                 r2 = h_lam             W_r2 = B_lam (payoff folded)
        columns: c1 = (z (x) z_pi)      W_c1 = zP (x) zpiP
                 c2 = (h_z (x) h_zpi)   W_c2 = Qhz (x) Qhzpi

    and the epilogue splits row/column with this grouping: log_A3
    depends on (z, z_pi, h_z, h_zpi) — a general (c1, c2) matrix — and
    log_A2 on h_c only.  The Kronecker products trade ~7x more
    multiplies for large matmul shapes ((n_z n_zpi)^2 instead of
    skinny per-axis factors); the memory traffic (the bound at scale) is
    the same two passes per phase.  Putting the Kronecker groups on the
    *column* side keeps the minor dimension large (n_hz*n_hzpi).

    The field view is ``ell[d, l, a, b, c, e]`` (h_c, h_lam leading);
    ``ops.perm`` / ``ops.inv_perm`` carry the transposition from the
    natural ``(z, z_pi, h_z, h_c, h_zpi, h_lam)`` layout.

    ``baseline="loglinear"`` builds the *normalized* operand set: the
    log-linear baseline ell0 (``discrete_gcy.gcy_loglinear_parts``) is a
    sum of row-separable terms (phi_d, phi_l — conjugated into the
    shared row factors), pure-column terms (A0, phi_c, phi_e — carried
    by sub_col/add_col and the shared part of the c2 factor), and a
    (c1, c2)-coupled part that is exactly RANK-2 separable over the
    grouping,

        g(p, q) = (A_z k_pi + A_zpi) sigma_zpi(e) * ladpi(b)
                  + A_z sigma_z(c) * zlad(a),
        p = (a, b) = (z, z_pi),  q = (c, e) = (h_z, h_zpi),

    because ``discretize_gcy`` builds z_states = centers(e, b) +
    sigma_z(c) * ladder(a) (both Rouwenhorst and Tauchen;
    reference twin ``gcy_wc_ratio.py:109-120``).  The coupled part rides
    the column factors as diagonal conjugations batched the two
    supported ways (c1 over next c2, c2 over current c1), of the rank-2
    form W[b] = exp(logW0 + t1[b] D1 + t2[b] D2) — the
    generalization of the SSY rank-1 machinery — so the normalized set
    covers wide-Rouwenhorst GCY grids whose plain operands NaN in f32.
    """
    from .discrete_gcy import _gcy_factors

    if baseline is not None:
        if baseline != "loglinear":
            raise ValueError(f"unknown baseline {baseline!r}")
        return _two_phase_operands_gcy_normalized(model, disc)

    n_a, n_b, n_c, n_d, n_e, n_l = disc.shapes
    B_lam, A2, A3 = _gcy_factors(model, disc)
    W_c1 = _kron(disc.z_P, disc.z_pi_P)
    W_c2 = _kron(disc.h_z_Q, disc.h_zpi_Q)
    # log_A2 over d -> rows; log_A3 over current (a, b, c, e) -> columns.
    add_row = np.broadcast_to(
        np.log(np.asarray(A2, np.float64))[:, None], (n_d, n_l)).copy()
    add_col = np.log(np.asarray(A3, np.float64)).reshape(n_a * n_b,
                                                         n_c * n_e)
    # f32 range guard: the column phase shifts over the joint (z, z_pi)
    # and (h_z, h_zpi) groups; if theta * (log-linear ell span within a
    # column group) exceeds exp's f32 range, entire kron rows underflow
    # to exact zero -> -inf/NaN (docs/status.md #1 — GCY's theta = -36
    # hits this at ~2M+ point Rouwenhorst grids; the interaction
    # sigma_z(h_z) x z-ladder is non-separable, so no baseline fold can
    # remove it).  Wider grids are the f64 (XLA/CPU) tier.
    import warnings

    from .discrete_gcy import gcy_loglinear_parts
    ell0 = gcy_loglinear_parts(model, disc)["ell0"]
    span = float((ell0.max(axis=(0, 1, 2, 4))
                  - ell0.min(axis=(0, 1, 2, 4))).max())
    if abs(model.theta) * span > 85.0:
        warnings.warn(
            f"theta * (within-column-group log-w span) ~ "
            f"{abs(model.theta) * span:.0f} exceeds float32's exp range "
            "(~85): the f32 two-phase GCY operator will produce -inf/NaN on "
            "this grid. Shrink the z / h_z axes (Rouwenhorst spans grow "
            "like sqrt(n)) or use the float64 XLA chain.", stacklevel=2)

    ops = TwoPhaseOperands(
        shapes=(n_d, n_l, n_a * n_b, n_c * n_e),
        W_r1=np.asarray(disc.h_c_Q, np.float64),
        W_r2=np.asarray(B_lam, np.float64),
        W_c1=W_c1, W_c2=W_c2,
        add_row=add_row, add_col=add_col,
        theta=model.theta, beta=model.beta)
    # Natural layout (a, b, c, d, e, l) -> view layout (d, l, a, b, c, e).
    object.__setattr__(ops, "perm", (3, 5, 0, 1, 2, 4))
    object.__setattr__(ops, "inv_perm", (2, 3, 4, 0, 5, 1))
    object.__setattr__(ops, "state_shapes", tuple(disc.shapes))
    return ops


def _two_phase_operands_gcy_normalized(model, disc) -> TwoPhaseOperands:
    """Baseline-normalized GCY operand set (see
    :func:`two_phase_operands_gcy` for the derivation).  Equivalent math
    to the per-axis chain ``discrete_gcy._T_gcy_normalized`` regrouped
    into the 4-D two-phase form; exactness is asserted against it in
    tests/test_two_phase.py."""
    import warnings

    from .discrete_gcy import _gcy_factors, gcy_loglinear_parts

    n_a, n_b, n_c, n_d, n_e, n_l = disc.shapes
    P, Q = n_a * n_b, n_c * n_e
    theta = float(model.theta)
    parts = gcy_loglinear_parts(model, disc)
    co = parts["co"]

    # Rank-2 coupled column baseline from the discretization's ladder
    # structure (z_states = centers(e, b) + sigma_z(c) * zlad(a)).
    sigma_zpi = np.asarray(disc.sigma_zpi_states, np.float64)   # (e,)
    sigma_z = np.asarray(disc.sigma_z_states, np.float64)       # (c,)
    ladpi = np.asarray(disc.z_pi_states, np.float64)[0] / sigma_zpi[0]
    kpi = model.rho_pi / (1.0 - model.rho)
    zst = np.asarray(disc.z_states, np.float64)                 # (b,c,e,a)
    c00 = kpi * sigma_zpi[0] * ladpi[0]
    zlad = (zst[0, 0, 0, :] - c00) / sigma_z[0]                 # (a,)
    u1 = np.broadcast_to(ladpi[None, :], (n_a, n_b)).reshape(P)
    u2 = np.broadcast_to(zlad[:, None], (n_a, n_b)).reshape(P)
    t1 = np.broadcast_to(
        ((co["A_z"] * kpi + co["A_zpi"]) * sigma_zpi)[None, :],
        (n_c, n_e)).reshape(Q)
    t2 = np.broadcast_to((co["A_z"] * sigma_z)[:, None],
                         (n_c, n_e)).reshape(Q)
    g = u1[:, None] * t1[None, :] + u2[:, None] * t2[None, :]   # (P, Q)
    # Verify against the evaluated baseline: psi_z + psi_pi as (P, Q).
    psi_z_PQ = (co["A_z"] * zst).transpose(3, 0, 1, 2).reshape(P, Q)
    psi_pi_PQ = np.broadcast_to(
        (co["A_zpi"] * np.asarray(disc.z_pi_states, np.float64)
         ).T[None, :, None, :],
        (n_a, n_b, n_c, n_e)).reshape(P, Q)
    target = psi_z_PQ + psi_pi_PQ
    scale = max(1.0, float(np.max(np.abs(target))))
    # Tolerance scales with the grids' storage precision: an f32-built
    # discretization (discretize_gcy(dtype=jnp.float32)) rounds a truly
    # separable ladder by ~eps(f32) per entry.  Accepting it is exact —
    # the fold uses the rank-2 reconstruction g consistently in both the
    # sub and add corrections, so ANY g yields an exact normalized
    # operator; g only needs to approximate the baseline well for range
    # reduction, and an O(1e-6)-off reconstruction is immaterial there.
    # Truly non-separable grids differ at O(1) and are still rejected.
    eps = float(np.finfo(np.asarray(disc.z_states).dtype).eps)
    if np.max(np.abs(g - target)) > max(1e-9, 100.0 * eps) * scale:
        raise ValueError(
            "normalized GCY fold requires the separable z-ladder "
            "structure (z_states = centers(e, b) + sigma_z(c) * "
            "ladder(a)); this discretization does not match — use the "
            "per-axis XLA chain (T_gcy_factory baseline='loglinear')")

    # Row factors: per-axis-separable baseline parts conjugate into the
    # shared matrices (h_c with phi_d; B_lam/h_lam with phi_l).
    phi_d, phi_l = parts["phi_d"], parts["phi_l"]
    B_lam, A2, A3 = _gcy_factors(model, disc)
    W_r1 = (np.asarray(disc.h_c_Q, np.float64)
            * np.exp(theta * (phi_d[None, :] - phi_d[:, None])))
    W_r2 = (np.asarray(B_lam, np.float64)
            * np.exp(theta * (phi_l[None, :] - phi_l[:, None])))

    # Column factors: W_c1[q'] = _kron(zP, zpiP) conjugated by
    # e^{theta g(., q')} (batched over NEXT c2); W_c2[p] = _kron(Qhz,
    # Qhzpi) conjugated by e^{theta g(p, .)} (batched over CURRENT c1),
    # with the pure-q parts phi_c + phi_e as a batch-constant
    # conjugation folded into the shared log0.
    with np.errstate(divide="ignore"):
        logWc1 = np.log(_kron(disc.z_P, disc.z_pi_P))            # (P, P')
        logWc2 = np.log(_kron(disc.h_z_Q, disc.h_zpi_Q))         # (Q, Q')
    phi_ce = np.broadcast_to(parts["phi_c_"][:, None],
                             (n_c, n_e)).copy()
    phi_ce = (phi_ce + parts["phi_e"][None, :]).reshape(Q)
    D1 = theta * (u1[None, :] - u1[:, None])                    # (P, P')
    D2 = theta * (u2[None, :] - u2[:, None])
    E1 = theta * (t1[None, :] - t1[:, None])                    # (Q, Q')
    E2 = theta * (t2[None, :] - t2[:, None])
    log0_c2 = logWc2 + theta * (phi_ce[None, :] - phi_ce[:, None])

    # Dense batched factors for the plain evaluator.  One vectorized
    # pass per factor (exp in place over the log argument), with the
    # f32 exp-headroom measured from the same buffer.
    # Per-slice loop with preallocated output: the equivalent
    # one-shot broadcast expression hits a ~300x-slower numpy
    # iteration path on large leading-broadcast temporaries
    # (measured 132 s vs 0.44 s at (256, 512, 512) on this host).
    W_c1 = np.empty((Q, P, P), np.float64)
    for q in range(Q):
        np.multiply(D1, t1[q], out=W_c1[q])
        W_c1[q] += t2[q] * D2
        W_c1[q] += logWc1
    fac_max = float(W_c1.max())
    np.exp(W_c1, out=W_c1)
    W_c2 = np.empty((P, Q, Q), np.float64)
    for p in range(P):
        np.multiply(E1, u1[p], out=W_c2[p])
        W_c2[p] += u2[p] * E2
        W_c2[p] += log0_c2
    fac_max = max(fac_max, float(W_c2.max()))
    np.exp(W_c2, out=W_c2)
    if fac_max > 45.0:
        warnings.warn(
            f"normalized-operator folded factors reach "
            f"e^{fac_max:.0f}, beyond float32's exp-range headroom: "
            "the f32 two-phase evaluator will produce inf/NaN on "
            "this grid.  Shrink the z / h_z axes, use "
            "discretization='tauchen', or the float64 chain.",
            stacklevel=3)

    # sub/add: theta * ell0 split over (rows, columns); add restores it
    # plus the true epilogue terms.
    E_col = (co["A0"] + phi_ce[None, :] + g)                    # (P, Q)
    sub_row = theta * (phi_d[:, None] + phi_l[None, :])         # (d, l)
    sub_col = theta * E_col
    add_row = (np.broadcast_to(
        np.log(np.asarray(A2, np.float64))[:, None], (n_d, n_l)).copy()
        + sub_row)
    logA3 = np.log(np.asarray(A3, np.float64)).reshape(P, Q)
    add_col = logA3 + sub_col
    ell0_view = np.transpose(parts["ell0"],
                             (3, 5, 0, 1, 2, 4)).reshape(n_d, n_l, P, Q)

    ops = TwoPhaseOperands(
        shapes=(n_d, n_l, P, Q),
        W_r1=W_r1, W_r2=W_r2, W_c1=W_c1, W_c2=W_c2,
        add_row=add_row, add_col=add_col,
        theta=theta, beta=float(model.beta),
        sub_row=sub_row, sub_col=sub_col, baseline_log_w=ell0_view)
    object.__setattr__(ops, "perm", (3, 5, 0, 1, 2, 4))
    object.__setattr__(ops, "inv_perm", (2, 3, 4, 0, 5, 1))
    object.__setattr__(ops, "state_shapes", tuple(disc.shapes))
    return ops


def make_xla_two_phase_T(ops: TwoPhaseOperands, dtype=jnp.float32,
                         precision: str = "highest") -> Callable:
    """Plain-XLA evaluator of a two-phase operand set.

    The two-phase grouping contracted in plain JAX, GSPMD-shardable; the
    per-axis operators are its agreement oracle in the tests.

    ``precision``: "highest" (default), "3x" (three-pass bf16 hi/lo
    splits — ``ops/contract.einsum_p``; ~2^-17 relative, the tier for
    Newton inner matvecs whose forcing tolerance is 1e-4-class), or
    "default".  f64 always contracts at HIGHEST.
    """
    pair = getattr(ops, "pair_c2", None)
    n_r1, n_r2, n_c1, n_c2 = ops.shapes
    R, C = n_r1 * n_r2, n_c1 * n_c2
    cast = lambda a: jnp.asarray(a, dtype)
    W_r1, W_r2, W_c1 = map(cast, (ops.W_r1, ops.W_r2, ops.W_c1))
    W_c2 = None if pair is not None else cast(ops.W_c2)
    if pair is not None:
        # Pair-factored batched c2 (continuous GCY): the joint factor is
        # never materialized — contract next-z_pi then next-z per the
        # factored chain (exactly the joint product; see
        # two_phase_operands_gcy_continuous).
        Pz_p, Pzpi_p = (cast(p) for p in pair)   # (i,j,b,J) / (y,b,B)
        n_i, n_y, n_b, n_j = ops.pair_shapes
    add = cast(ops.add_row[:, :, None]
               + ops.add_col.reshape(-1)[None, None, :])     # (r1, r2, C)
    sub = None
    if ops.has_sub:
        sub = cast(ops.sub_row.reshape(-1)[:, None, None]
                   + ops.sub_col[None, :, :])                # (R, c1, c2)
    theta = jnp.asarray(ops.theta, dtype)
    beta = jnp.asarray(ops.beta, dtype)
    c1_sub = "jim,tmj->tij" if ops.c1_batched else "im,tmj->tij"
    c2_sub = "ijm,tim->tij" if ops.c2_batched else "jm,tim->tij"
    # True-f32 matmuls by default (a device default of reduced-precision
    # matmul passes loses digits on one application); accurate
    # transcendentals (see ops/accurate.py).
    from ..ops.accurate import accurate_exp, accurate_log, accurate_log1p
    from ..ops.contract import einsum_p
    if precision not in ("highest", "3x", "default"):
        raise ValueError(f"unknown precision {precision!r}")
    ein = lambda sub_, A, B: einsum_p(sub_, A, B, precision)

    def T(ell):
        a = theta * ell.astype(dtype).reshape(R, n_c1, n_c2)
        if sub is not None:
            a = a - sub
        m = jnp.max(a, axis=1, keepdims=True)
        a = m + accurate_log(ein(c1_sub, W_c1, accurate_exp(a - m)))
        m = jnp.max(a, axis=2, keepdims=True)
        if pair is not None:
            e = accurate_exp(a - m).reshape(R, n_i, n_y, n_b, n_j)
            v = ein("ybB,tiyBJ->tiybJ", Pzpi_p, e)
            u = ein("ijbJ,tiybJ->tiybj", Pz_p, v)
            a = m + accurate_log(u.reshape(R, n_c1, n_c2))
        else:
            a = m + accurate_log(ein(c2_sub, W_c2, accurate_exp(a - m)))
        b = a.reshape(n_r1, n_r2, C)
        m = jnp.max(b, axis=0, keepdims=True)
        b = m + accurate_log(ein("lm,mkt->lkt", W_r1,
                                 accurate_exp(b - m)))
        m = jnp.max(b, axis=1, keepdims=True)
        b = m + accurate_log(ein("km,lmt->lkt", W_r2,
                                 accurate_exp(b - m)))
        log_hwt = b + add
        return accurate_log1p(
            beta * accurate_exp(log_hwt / theta)).reshape(ops.shapes)

    return T
