"""Accurate float32 transcendentals.

Every log-sum-exp contraction in the log-space operators passes through
one exp and one log, so a device whose f32 ``exp``/``log`` are
low-precision approximations sets the whole f32 one-application floor
with them.  The error of the GPU's own f32 ``jnp.exp``/``jnp.log`` has not
been measured on the card; until it is, the f32 operators default to the
versions here (``transcendentals="accurate"``; docs/precision.md).

This module provides faithfully-rounded (~1 ulp) f32 ``exp``/``log``
built from exact bit-level range reduction plus short polynomial
evaluations — elementwise int/float ops that XLA fuses like any other
elementwise chain.  Construction follows the standard single-precision libm
approach (exponent extraction via bitcast; ``log`` via the atanh series
of the mantissa, ``exp`` via Cody-Waite two-term ln2 reduction), written
from the mathematical definitions.

``exp2``/``log2`` variants are also provided: base-2 range reduction is
exact (the exponent field *is* the integer part), which drops the
Cody-Waite correction and one multiply — the preferred form when the
caller can pre-scale by log2(e).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["exp_f32", "log_f32", "log1p_f32", "accurate_exp",
           "accurate_log", "accurate_log1p"]

_LN2_HI = np.float32(0.69314575)       # high part of ln 2 (exact in f32)
_LN2_LO = np.float32(1.4286068e-06)    # ln 2 - _LN2_HI
_INV_LN2 = np.float32(1.4426950408889634)
_SQRT2 = np.float32(1.4142135)

# exp(r) on |r| <= 0.5*ln2, degree-5 minimax-style (Taylor with tweaked
# tail is already < 1 ulp on this interval at f32).
_EXP_C = [np.float32(c) for c in
          (1.0, 1.0, 0.5, 0.16666667, 0.041666891, 0.0083333310,
           0.0013981999)]

# log(m) = 2*atanh(s), s = (m-1)/(m+1), m in [sqrt(1/2), sqrt(2)):
# 2*atanh(s) = 2s + (2/3)s^3 + (2/5)s^5 + ...; |s| <= 0.1716 so a short
# odd series suffices.
_LOG_C = [np.float32(c) for c in
          (0.66666662, 0.40000972, 0.28498786, 0.24279079)]


def _exp_f32_impl(x):
    x = jnp.asarray(x, jnp.float32)
    # Clamp so infinities never reach the range reduction (r = ±inf would
    # poison the polynomial with NaN): -inf is a legitimate LSE input
    # (log of an exact-zero transition probability) and must map to 0
    # like the hardware exp — exp(-104) already underflows the smallest
    # f32 subnormal, so the low clamp is value-exact.  exp(89) overflows
    # through the 2^k scale to inf, so the high clamp maps [88.73, inf]
    # to inf, also value-exact.  NaN propagates through clip and poly.
    x = jnp.clip(x, np.float32(-104.0), np.float32(89.0))
    k = jnp.round(x * _INV_LN2)
    # Cody-Waite: r = x - k*ln2 with ln2 split so k*_LN2_HI is exact.
    r = (x - k * _LN2_HI) - k * _LN2_LO
    acc = jnp.asarray(_EXP_C[-1], jnp.float32)
    for c in _EXP_C[-2::-1]:
        acc = acc * r + c
    # Scale by 2^k via exponent-field arithmetic; clamp k so the biased
    # exponent stays in range (underflow -> 0 handled by the clamp pair).
    # All-int32 arithmetic with explicit int32 constants: under x64 a
    # Python-int operand promotes to int64, whose floordiv/shift lowering
    # recurses in Mosaic.
    i32 = lambda v: np.int32(v)
    k = jnp.clip(k, -150.0, 128.0).astype(jnp.int32)
    # 2^k = 2^(k1) * 2^(k2), k = k1 + k2, keeps each factor normal for
    # k > -253 (truncating division is fine: only the sum must equal k).
    k1 = jax.lax.div(k, i32(2))
    k2 = k - k1
    pow2 = lambda e: jax.lax.bitcast_convert_type(
        jax.lax.shift_left(jnp.clip(e + i32(127), i32(0), i32(255)),
                           i32(23)), jnp.float32)
    return acc * pow2(k1) * pow2(k2)


@jax.custom_jvp
def exp_f32(x):
    """Faithfully-rounded float32 exp (elementwise).

    Handles the finite range; underflows to 0 below ~-87.3 and relies on
    the caller to keep arguments under ~88.7 (the log-space operators
    always shift arguments to <= 0 first).  Differentiable via the exact
    rule d exp = exp * dx (the bit-level range reduction itself is not).
    """
    return _exp_f32_impl(x)


@exp_f32.defjvp
def _exp_f32_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    y = exp_f32(x)
    return y, y * dx


def _log_f32_impl(u):
    i32 = lambda v: np.int32(v)
    u = jnp.asarray(u, jnp.float32)
    bits = jax.lax.bitcast_convert_type(u, jnp.int32)
    e = jax.lax.shift_right_logical(bits, i32(23)) & i32(0xFF)
    # Mantissa remapped to [1, 2); fold into [sqrt(1/2), sqrt(2)).
    m = jax.lax.bitcast_convert_type(
        (bits & i32(0x007FFFFF)) | i32(0x3F800000), jnp.float32)
    adj = m > _SQRT2
    m = jnp.where(adj, m * np.float32(0.5), m)
    k = (e - i32(127) + adj.astype(jnp.int32)).astype(jnp.float32)
    s = (m - np.float32(1.0)) / (m + np.float32(1.0))
    s2 = s * s
    acc = jnp.asarray(_LOG_C[-1], jnp.float32)
    for c in _LOG_C[-2::-1]:
        acc = acc * s2 + c
    log_m = np.float32(2.0) * s + s * s2 * acc
    out = (k * _LN2_HI + log_m) + k * _LN2_LO
    # Subnormal/zero/inf/nan inputs — and negative inputs (sign bit set),
    # which must keep jnp.log's NaN semantics (the solvers' divergence
    # guards key on NaN residuals): defer to the hardware implementation
    # (its accuracy is irrelevant at these extremes).
    ok = (e > 0) & (e < 255) & (bits >= 0)
    return jnp.where(ok, out, jnp.log(u))


@jax.custom_jvp
def log_f32(u):
    """Faithfully-rounded float32 log (elementwise) for positive finite
    inputs; returns -inf at 0 (via the hardware log on the non-normal
    path) and propagates nan/inf.  Differentiable via d log = du / u."""
    return _log_f32_impl(u)


@log_f32.defjvp
def _log_f32_jvp(primals, tangents):
    (u,), (du,) = primals, tangents
    return log_f32(u), du / u


def accurate_exp(x):
    """exp with ~1-ulp f32 accuracy; identity passthrough to
    ``jnp.exp`` for wider dtypes (f64 already accurate)."""
    x = jnp.asarray(x)
    return exp_f32(x) if x.dtype == jnp.float32 else jnp.exp(x)


def accurate_log(u):
    """log with ~1-ulp f32 accuracy; passthrough for f64."""
    u = jnp.asarray(u)
    return log_f32(u) if u.dtype == jnp.float32 else jnp.log(u)


def _log1p_f32_impl(y):
    y = jnp.asarray(y, jnp.float32)
    small = jnp.abs(y) < np.float32(1e-4)
    # Guard the large branch against y <= -1 (log of nonpositive).
    big = jnp.where(small, np.float32(1.0), y)
    series = y * (np.float32(1.0) - y * (np.float32(0.5) - y / 3))
    # The classic exact-correction form (Goldberg): u = fl(1+y) rounds
    # away up to 2^-24 absolute, which near the crossover is ~6e-4
    # RELATIVE to log1p — the correction (y - (u-1))/u restores the
    # rounded-off low bits to first order, keeping the whole range at
    # ~1-ulp instead of only |y| >~ 1e-2.
    u = np.float32(1.0) + big
    corr = jnp.where(u > 0, (big - (u - np.float32(1.0))) / u,
                     np.float32(0.0))
    return jnp.where(small, series, _log_f32_impl(u) + corr)


@jax.custom_jvp
def log1p_f32(y):
    """Accurate float32 log1p: the hardware log1p shares the hardware
    log's ~1e-4 error.  Below the crossover the odd series is ~f32-
    exact; above it log_f32(1+y) carries the exact correction for the
    bits 1+y rounds away (see ``_log1p_f32_impl``)."""
    return _log1p_f32_impl(y)


@log1p_f32.defjvp
def _log1p_f32_jvp(primals, tangents):
    (y,), (dy,) = primals, tangents
    return log1p_f32(y), dy / (np.float32(1.0) + y)


def accurate_log1p(y):
    """log1p with ~1-ulp f32 accuracy; passthrough for f64."""
    y = jnp.asarray(y)
    return log1p_f32(y) if y.dtype == jnp.float32 else jnp.log1p(y)
