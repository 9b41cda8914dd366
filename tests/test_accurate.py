"""Accurate f32 transcendentals: faithful rounding, edge cases, autodiff,
and the operator-level accuracy they buy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdfs_via_autodiff_tpu.ops.accurate import (accurate_exp, accurate_log,
                                                accurate_log1p, exp_f32,
                                                log1p_f32, log_f32)


def test_exp_f32_faithful():
    x = jnp.asarray(np.linspace(-87.0, 80.0, 200001), jnp.float32)
    got = np.asarray(exp_f32(x), np.float64)
    ref = np.exp(np.asarray(x, np.float64))
    rel = np.max(np.abs(got - ref) / ref)
    assert rel < 3e-7, rel           # ~1 ulp of f32


def test_log_f32_faithful():
    u = jnp.asarray(np.exp(np.linspace(-87.0, 80.0, 200001)), jnp.float32)
    got = np.asarray(log_f32(u), np.float64)
    ref = np.log(np.asarray(u, np.float64))
    # absolute error bounded by ~1 ulp of the result (|log u| <= 87)
    assert np.max(np.abs(got - ref)) < 1.2e-5
    # relative-to-ulp check on moderate outputs
    mid = (np.abs(ref) > 0.5) & (np.abs(ref) < 4.0)
    assert np.max(np.abs(got[mid] - ref[mid])) < 5e-7


def test_log1p_f32_branches():
    y = jnp.asarray(np.concatenate([np.linspace(-0.5, 2.0, 100001),
                                    np.linspace(-9e-5, 9e-5, 10001),
                                    [700.0, 0.0]]), jnp.float32)
    got = np.asarray(log1p_f32(y), np.float64)
    ref = np.log1p(np.asarray(y, np.float64))
    assert np.max(np.abs(got - ref)) < 1e-6


def test_exp_log_edge_cases():
    assert float(exp_f32(jnp.float32(-200.0))) == 0.0
    assert float(exp_f32(jnp.float32(0.0))) == 1.0
    assert np.isposinf(float(log_f32(jnp.float32(np.inf))))
    assert np.isneginf(float(log_f32(jnp.float32(0.0))))
    assert np.isnan(float(log_f32(jnp.float32(np.nan))))


def test_round_trip():
    x = jnp.asarray(np.linspace(-40.0, 40.0, 100001), jnp.float32)
    got = np.asarray(log_f32(exp_f32(x)), np.float64)
    assert np.max(np.abs(got - np.asarray(x, np.float64))) < 1e-5


@pytest.mark.slow


def test_custom_jvp_rules():
    x = jnp.asarray([-3.0, -0.5, 0.7, 5.0], jnp.float32)
    v = jnp.ones_like(x)
    _, de = jax.jvp(exp_f32, (x,), (v,))
    np.testing.assert_allclose(np.asarray(de), np.exp(np.asarray(x)),
                               rtol=1e-6)
    u = jnp.exp(x)
    _, dl = jax.jvp(log_f32, (u,), (jnp.ones_like(u),))
    np.testing.assert_allclose(np.asarray(dl), 1.0 / np.asarray(u), rtol=1e-6)
    _, dl1 = jax.jvp(log1p_f32, (u,), (jnp.ones_like(u),))
    np.testing.assert_allclose(np.asarray(dl1), 1.0 / (1.0 + np.asarray(u)),
                               rtol=1e-6)
    # reverse mode through the wrappers
    g = jax.grad(lambda a: jnp.sum(log_f32(exp_f32(a))))(x)
    np.testing.assert_allclose(np.asarray(g), 1.0, rtol=1e-5)


def test_accurate_passthrough_f64():
    x = jnp.asarray([0.5, 1.5])   # f64 under the test config
    assert accurate_exp(x).dtype == jnp.float64
    assert accurate_log(x).dtype == jnp.float64
    assert accurate_log1p(x).dtype == jnp.float64


@pytest.mark.slow


def test_two_phase_f32_one_application_floor():
    # Operator-level payoff: the f32 two-phase twin must sit at the
    # few-ulp floor vs f64 (on the CPU the hardware transcendentals are
    # accurate too, so this guards the software path's correctness).
    from sdfs_via_autodiff_tpu import SSY, build_grid_ssy
    from sdfs_via_autodiff_tpu.operators.two_phase import (
        make_xla_two_phase_T, two_phase_operands_ssy_continuous)
    model = SSY()
    grids = build_grid_ssy(model, 8, 8, 8, 8)
    ops = two_phase_operands_ssy_continuous(model, grids, 4, None)
    rng = np.random.default_rng(0)
    ell = np.log(700.0) + 0.15 * rng.standard_normal((8,) * 4)
    o32 = np.asarray(make_xla_two_phase_T(ops, jnp.float32)(
        jnp.asarray(ell, jnp.float32)), np.float64)
    o64 = np.asarray(make_xla_two_phase_T(ops, jnp.float64)(jnp.asarray(ell)))
    assert np.max(np.abs(o32 - o64)) < 5e-6


def test_exp_f32_infinities():
    # -inf is a legitimate LSE input (log of a zero transition entry) and
    # must map to 0, exactly like the hardware exp; +inf overflows to inf.
    vals = np.asarray(exp_f32(jnp.asarray([-np.inf, np.inf, -104.0, -103.0],
                                          jnp.float32)))
    assert vals[0] == 0.0
    assert np.isposinf(vals[1])
    assert vals[2] == 0.0
    assert vals[3] > 0.0 or vals[3] == 0.0  # deep subnormal: flush ok


def test_log_f32_negative_is_nan():
    # Negative normal inputs must keep jnp.log's NaN semantics (the
    # solvers' divergence guards key on NaN residuals), not silently
    # return log|u| via the polynomial path.
    u = jnp.asarray([-1.0, -0.5, -1e30, -1e-30, -np.inf], jnp.float32)
    got = np.asarray(log_f32(u))
    assert np.all(np.isnan(got)), got
    # Positive path unaffected.
    assert np.isfinite(float(log_f32(jnp.float32(2.0))))


def test_log1p_accurate_through_the_crossover():
    # The series/direct crossover must not open an accuracy hole: fl(1+y)
    # rounds away up to 2^-24, which near y ~ 1e-4 is ~6e-4 RELATIVE to
    # log1p unless the rounded-off bits are restored (exact-correction
    # form).  Sweep both signs across six decades.
    ys = np.float32(np.concatenate([np.geomspace(1e-6, 0.5, 2001),
                                    -np.geomspace(1e-6, 0.5, 2001)]))
    got = np.asarray(log1p_f32(jnp.asarray(ys)), np.float64)
    ref = np.log1p(np.asarray(ys, np.float64))
    rel = np.abs(got - ref) / np.abs(ref)
    assert rel.max() < 5e-7, (rel.max(), ys[rel.argmax()])
