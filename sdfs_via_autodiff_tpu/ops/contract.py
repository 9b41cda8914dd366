"""Log-sum-exp factored contractions.

``log(M @ exp(a))`` computed with a shift along the contracted axis:

    m = max(a, axis); result = m + log(M @ exp(a - m))

Each step stays a dense matmul with all exponentials in (0, 1].
A *single global* shift (as in a naive log-space formulation) overflows
f32 once the iterate's dynamic range exceeds exp's range — at the SSY
calibration theta*Delta(log w) passes the f32 limit (~87) already on
~50^4 Rouwenhorst grids, whose ladders span ±7 standard deviations.  The
per-axis shifts here are exact (no clamping) and cost one max/exp/log per
contraction step.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["lse_matmul", "einsum_p"]


def einsum_p(subscripts: str, M, E, precision: str = "highest"):
    """Two-operand einsum with a named precision tier.

    "highest": true-f32 matmuls (the accuracy default; on the GPU the
    default precision would run f32 operands in TF32).  "3x": three
    bf16 products on hi/lo operand splits (~2^-17 relative on positive
    summands; the inexact-Newton inner matvecs with inner_tol=1e-4 are
    its intended consumer).  "default": the device's default precision
    (~1e-3, throughput experiments).  float64 operands always use
    HIGHEST (the bf16 split would destroy f64 precision)."""
    if precision not in ("highest", "3x", "default"):
        raise ValueError(f"unknown precision {precision!r} "
                         "(choose 'highest', '3x', or 'default')")
    if precision == "3x" and jnp.result_type(M, E) == jnp.float32:
        Mh = M.astype(jnp.bfloat16)
        Ml = (M - Mh.astype(jnp.float32)).astype(jnp.bfloat16)
        Eh = E.astype(jnp.bfloat16)
        El = (E - Eh.astype(jnp.float32)).astype(jnp.bfloat16)
        ein = lambda a, b: jnp.einsum(subscripts, a, b,
                                      preferred_element_type=jnp.float32)
        return ein(Mh, Eh) + ein(Mh, El) + ein(Ml, Eh)
    prec = (jax.lax.Precision.DEFAULT if precision == "default"
            else jax.lax.Precision.HIGHEST)
    return jnp.einsum(subscripts, M, E, precision=prec)


def _contracted_dims(subscripts, axis):
    """(ms, out, kdim): M's labels, output labels, and the position of
    the contracted label within M for an lse_matmul-style einsum."""
    ins, out = subscripts.split("->")
    ms, vs = ins.split(",")
    contracted = vs[axis]
    return ms, out, ms.index(contracted), contracted


def _scale_to_output(s, ms, out, contracted, xp=jnp):
    """Reshape a per-row scale ``s`` (M's non-contracted labels, in M
    order) to broadcast against the einsum OUTPUT."""
    labels = [l for l in ms if l != contracted]
    assert all(l in out for l in labels), (ms, out)
    # Transpose s's labels into output order, then expand the missing
    # output labels as singleton axes.
    order = sorted(range(len(labels)), key=lambda i: out.index(labels[i]))
    s_t = xp.transpose(s, order)
    shape, i = [], 0
    for l in out:
        if i < len(labels) and l == labels[order[i]]:
            shape.append(s_t.shape[i])
            i += 1
        else:
            shape.append(1)
    return s_t.reshape(shape)


def _rowsum_align(M, subscripts, axis):
    """Row-normalize ``M`` over its contracted label, returning the
    normalized matrix and ``log(rowsum)`` reshaped to broadcast against
    the einsum OUTPUT.

    Moving the row scale into a log-domain add is exact (``log s +
    log(M^ @ e^v)``) and twice useful: conditioned operand matrices can
    carry folded payoff factors spanning many decades (measured ~e^38
    on GCY calibrations), which both waste the f32 window and hide the
    row's true locality; and after normalization every row has an entry
    >= 1/n, so a row can only underflow when ALL its mass sits below
    the slice max's f32 window — the case the ``deep_window`` second
    pass covers.  Requires every non-contracted label of ``M`` to
    appear in the output (true for all the per-axis chains here).
    """
    ms, out, kdim, contracted = _contracted_dims(subscripts, axis)
    s = M.sum(axis=kdim)
    Mn = M / jnp.expand_dims(jnp.where(s == 0, jnp.ones_like(s), s), kdim)
    return Mn, jnp.log(_scale_to_output(s, ms, out, contracted))


def normalize_rows_log(logM, subscripts, axis):
    """Construction-time (host numpy, float64) log-domain row
    normalization for an :func:`lse_matmul` operand.

    ``lse_matmul``'s internal normalization is too late when the f32
    CAST of the assembled matrix already over/underflowed: folded
    baseline factors reach e^{+-hundreds} on wide-Rouwenhorst GCY grids
    (measured at the 25.2M north-star case — ``astype(float32)`` made
    inf entries, inf rowsums, NaN everywhere).  Never materializing
    ``exp(logM)`` un-normalized closes that: returns ``(Mn, log_s)``
    with ``Mn = exp(logM - logsumexp_row)`` (max entry per row >= 1/n —
    immune to any float32 cast) and ``log_s`` (float64) reshaped to
    broadcast against the einsum output, to be added to the
    contraction's result.
    """
    import numpy as np

    ms, out, kdim, contracted = _contracted_dims(subscripts, axis)
    mx = np.max(logM, axis=kdim, keepdims=True)
    mx = np.where(np.isfinite(mx), mx, 0.0)
    log_s = (np.squeeze(mx, kdim)
             + np.log(np.sum(np.exp(logM - mx), axis=kdim)))
    Mn = np.exp(logM - np.expand_dims(log_s, kdim))
    return Mn, _scale_to_output(log_s, ms, out, contracted, xp=np)


def _trx_pair(transcendentals: str):
    """(exp, log) implementations for a transcendentals tier name."""
    if transcendentals == "fast":
        return jnp.exp, jnp.log
    if transcendentals == "mixed":
        from .accurate import accurate_log
        return jnp.exp, accurate_log
    if transcendentals == "accurate":
        from .accurate import accurate_exp, accurate_log
        return accurate_exp, accurate_log
    raise ValueError(f"unknown transcendentals {transcendentals!r}")


def _safe_shift(log_v, axis):
    """Per-slice max shift; 0 for all--inf slices (-inf - -inf = NaN)."""
    m = jnp.max(log_v, axis=axis, keepdims=True)
    return jnp.where(jnp.isfinite(m), m, jnp.zeros_like(m))


# Window-selection floor: the smallest NORMAL float32.  ``u > 0`` is the
# wrong predicate — a SUBNORMAL contraction result is "> 0" but carries
# as few as 1-2 mantissa bits, so log(u) quantizes in ~0.1-nat steps.
# Measured consequence (round 5, 12.6M wide-Rouwenhorst SSY): corner
# rows whose pass-1 result landed subnormal injected ~0.1-nat noise per
# application, and BOTH Newton and Anderson stalled at residual ~0.1 —
# the noise floor, not a convergence failure.  Selecting only full-
# precision (normal) results lets those rows fall through to the deeper
# window, which represents them with a full mantissa.
_MIN_NORMAL_F32 = float(np.finfo(np.float32).tiny)


def _deep_passes(Mn, log_v, subscripts, axis, exp_, log_, precision, W, K):
    """K-window LSE: pass k shifts by k*W, the shallowest pass whose
    contraction stayed NORMAL (full f32 precision — see
    ``_MIN_NORMAL_F32``) is selected per output element.  Pass-k
    exponents are clamped at +80 (e^80 < f32 max): a clamped term can
    only matter for rows already served by a shallower pass, and the
    clamp prevents 0 * inf = NaN against exact-zero matrix entries."""
    m = _safe_shift(log_v, axis)
    d = log_v - m
    u = einsum_p(subscripts, Mn, exp_(d), precision)
    out = m + log_(u)
    sel = u >= _MIN_NORMAL_F32
    for k in range(1, K):
        s = jnp.asarray(k * W, d.dtype)
        u_k = einsum_p(subscripts, Mn,
                       exp_(jnp.minimum(d + s, 80.0)), precision)
        out = jnp.where(sel, out, m - s + log_(u_k))
        sel = jnp.logical_or(sel, u_k >= _MIN_NORMAL_F32)
    return out


@partial(jax.custom_jvp, nondiff_argnums=(2, 3, 4, 5, 6, 7))
def _lse_matmul_deep(Mn, log_v, subscripts, axis, transcendentals,
                     precision, W, K):
    """Multi-window LSE contraction of a ROW-NORMALIZED ``Mn`` (see
    :func:`lse_matmul`); custom JVP so the tangent costs one einsum per
    WINDOW, not per pass of the autodiff'd primal.

    The naive autodiff of the multi-pass primal multiplies every
    tangent matvec and its residuals by the pass count, which at
    10^7-point grids exhausts device memory at compile time.  The
    fix is mathematical, not scheduling: for every window the exact
    derivative is the same softmax average ``d out = (Mn^ @ (exp(v - m
    + s) dv)) / u_s`` for any shift ``s`` whose contraction ``u_s``
    stayed above the flush floor, so the tangent needs only the K-1
    shifted windows ``W, 2W, ...`` (never the unshifted pass: window W
    covers everything it covers), each selected per output element at
    the shallowest non-flushed shift — identical coverage to the
    primal's pass union.  Rows deeper than the deepest window (beyond
    the primal's own coverage, so their PRIMAL is already -inf-floored)
    get a zero tangent row: inexact-Newton tolerates a Jacobian that
    drops unreachable rows — the safeguarded outer step checks the TRUE
    residual — and SA/Anderson never evaluate the tangent."""
    exp_, log_ = _trx_pair(transcendentals)
    return _deep_passes(Mn, log_v, subscripts, axis, exp_, log_,
                        precision, W, K)


@partial(_lse_matmul_deep.defjvp, symbolic_zeros=True)
def _lse_matmul_deep_jvp(subscripts, axis, transcendentals, precision, W,
                         K, primals, tangents):
    from jax.custom_derivatives import SymbolicZero

    Mn, log_v = primals
    dM, dv = tangents
    exp_, log_ = _trx_pair(transcendentals)
    out = _deep_passes(Mn, log_v, subscripts, axis, exp_, log_,
                       precision, W, K)
    m = _safe_shift(log_v, axis)
    d = log_v - m
    dout = jnp.zeros_like(out)
    served = jnp.zeros_like(out, dtype=bool)
    # Windows at shifts W, 2W, ..., (K-1)W: the same union of depths the
    # primal's passes cover (its unshifted pass 0 is a subset of the
    # W window).  Shift k*W is clamped at +80 exactly as in the primal
    # (_deep_passes): a clamped term only matters for rows served by a
    # shallower window, and the clamp prevents 0 * inf = NaN.
    for k in range(1, max(K, 2)):
        s = jnp.asarray(k * W, d.dtype)
        em = exp_(jnp.minimum(d + s, 80.0))
        u_k = einsum_p(subscripts, Mn, em, precision)
        num = jnp.zeros_like(out)
        if not isinstance(dv, SymbolicZero):
            num = einsum_p(subscripts, Mn, em * dv, precision)
        if not isinstance(dM, SymbolicZero):
            num = num + einsum_p(subscripts, dM, em, precision)
        ok = u_k >= _MIN_NORMAL_F32
        val = num / jnp.where(ok, u_k, 1.0)
        fresh = jnp.logical_and(~served, ok)
        dout = jnp.where(fresh, val, dout)
        served = jnp.logical_or(served, ok)
    return out, dout


def lse_matmul(M: jnp.ndarray, log_v: jnp.ndarray, subscripts: str,
               axis: int, transcendentals: str = "accurate",
               precision: str = "highest",
               deep_window: float = 0.0,
               deep_passes: int = 2) -> jnp.ndarray:
    """log of ``einsum(subscripts, M, exp(log_v))`` with a per-slice shift
    over the contracted ``axis`` of ``log_v``.

    ``subscripts`` must contract exactly the given axis of ``log_v`` and
    produce an output whose shape broadcasts against
    ``max(log_v, axis, keepdims=True)`` (true for all the per-axis
    contractions used by the operators, where the contracted axis is
    replaced by the matching current-state axis in place).

    All entries of ``M`` must be non-negative.  ``M`` is row-normalized
    internally (exact — the log row sum is added to the output; see
    :func:`_rowsum_align`), so folded payoff factors in conditioned
    operand matrices cannot eat into the exp window.

    ``deep_window=W`` (float32 inputs only; e.g. 80.0) adds a second
    matmul pass with the shift lowered by W: a LOCALIZED output row —
    e.g. a Rouwenhorst ladder corner, whose binomial weights
    concentrate far from the slice argmax — can have its entire mass
    below the single joint window (exp(v - m) flushes to 0, u = 0,
    log -> -inf even though the true output is finite, merely ~m - 150;
    first measured at the 25.2M wide-Rouwenhorst GCY north-star case).
    Pass 2 computes ``m - W + log(M^ @ exp(v - m + W))`` — its large
    terms stay under e^{W + ln n} < f32 max for W <= ~80 — and the
    result is selected per output element only where pass 1
    underflowed, extending coverage to ~(87 + W) nats for one extra
    (bandwidth-bound) matmul.  ``deep_passes=K`` stacks further
    windows at 2W, 3W, ... (each one more matmul): the 25.2M
    wide-Rouwenhorst GCY case measures output rows up to 183 nats
    below their slice max, past the two-pass union — K=3 covers ~247.

    ``transcendentals``: "accurate" (default) uses the faithfully-rounded
    software f32 exp/log (``ops/accurate.py``).  "fast" uses the
    device's own ``jnp.exp``/``jnp.log``, an escape hatch for
    speed-over-accuracy runs.  "mixed" pairs the device exp with the
    accurate log.  No-op for float64 either way.

    ``precision``: "highest" (default — true-f32 matmuls), "3x"
    (three-pass bf16 hi/lo splits, ~2^-17 relative at half the matmul
    cost — the Newton inner-matvec tier), or "default" (one bf16 pass);
    see :func:`einsum_p`.
    """
    exp_, log_ = _trx_pair(transcendentals)

    M, log_s = _rowsum_align(M, subscripts, axis)
    if deep_window and jnp.result_type(log_v) == jnp.float32:
        out = _lse_matmul_deep(M, log_v, subscripts, axis,
                               transcendentals, precision,
                               float(deep_window), int(deep_passes))
        return out + log_s
    m = _safe_shift(log_v, axis)
    # HIGHEST keeps f32 operands in true f32 (the GPU default runs them in
    # TF32, about three digits); these contractions are bandwidth-bound,
    # so the extra precision is ~free.  No-op for float64.
    u = einsum_p(subscripts, M, exp_(log_v - m), precision)
    return m + log_(u) + log_s
