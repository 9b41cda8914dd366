"""Continuous-state GCY operator tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from sdfs_via_autodiff_tpu import GCY, build_grid_gcy, next_state_gcy
from sdfs_via_autodiff_tpu.operators.continuous_gcy import (
    T_gcy_continuous_factory)

SIZES = (3, 3, 3, 3, 4, 3)


@pytest.fixture(scope="module")
def setup():
    model = GCY()
    grids = build_grid_gcy(model, *SIZES)
    return model, grids


def rand_w(rng, scale=500.0, spread=0.05):
    return jnp.asarray(scale * np.exp(spread * rng.standard_normal(SIZES)))


@pytest.mark.fast


def test_next_state_matches_dynamics(setup, rng):
    model, _ = setup
    x = jnp.asarray(rng.standard_normal(6) * 0.01)
    eps = jnp.asarray(rng.standard_normal((6, 8)))
    out = next_state_gcy(model, x, eps)
    m = model
    np.testing.assert_allclose(out[0], m.rho_lam * x[0] + m.s_lam * eps[0])
    np.testing.assert_allclose(out[3], m.rho_zpi * x[3] + m.s_zpi * eps[3])
    sigma_z = m.phi_z * np.exp(x[2])
    np.testing.assert_allclose(out[4], m.rho * x[4] + m.rho_pi * x[5]
                               + sigma_z * eps[4])
    sigma_zpi = m.phi_zpi * np.exp(x[3])
    np.testing.assert_allclose(out[5], m.rho_pipi * x[5] + sigma_zpi * eps[5])


def test_factored_equals_gather_pre(setup, rng):
    model, grids = setup
    T_fac = T_gcy_continuous_factory(model, grids, interp="pre",
                                     quad_degree=3)
    from sdfs_via_autodiff_tpu.operators.continuous_common import make_gather_T
    from sdfs_via_autodiff_tpu.operators.continuous_gcy import (
        _log_kappa_gcy, next_state_gcy as ns)
    from sdfs_via_autodiff_tpu.ops.quadrature import tensor_quadrature_normal
    nodes, weights = tensor_quadrature_normal([3] * 6)
    T_gather = make_gather_T(
        lambda x, s: ns(model, x, s),
        lambda x: _log_kappa_gcy(model, x[1], x[4]),
        grids, jnp.asarray(nodes), jnp.asarray(weights),
        "pre", "w", None, model.beta, model.theta)
    w = rand_w(rng)
    np.testing.assert_allclose(np.asarray(T_fac(w)), np.asarray(T_gather(w)),
                               rtol=1e-11)


def test_log_space_consistent(setup, rng):
    model, grids = setup
    w = rand_w(rng)
    for interp in ("pre", "post"):
        T = T_gcy_continuous_factory(model, grids, interp=interp,
                                     quad_degree=3)
        T_log = T_gcy_continuous_factory(model, grids, interp=interp,
                                         space="log", quad_degree=3)
        np.testing.assert_allclose(
            np.exp(np.asarray(T_log(jnp.log(w)))), np.asarray(T(w)),
            rtol=1e-11, err_msg=interp)


def test_end_to_end_continuous_solve(setup):
    from sdfs_via_autodiff_tpu import wc_ratio_continuous
    model, _ = setup
    sol = wc_ratio_continuous(model, SIZES, algorithm="newton", tol=1e-9,
                              interp="pre", quad_degree=3)
    assert sol.converged
    w = np.asarray(sol.w_star)
    assert w.shape == SIZES
    assert np.all(w > 1)
    # GCY w* sits lower than SSY's at coarse grids (beta~1 level
    # sensitivity); just pin the order of magnitude.
    assert 10 < w.mean() < 3000


def test_newton_safeguard_rescues_w_space(setup):
    # w-space Newton from w0=1 steps outside the domain (negative w,
    # where w^theta is NaN); the safeguard falls back to plain T steps and
    # recovers, while safeguard=False reports an honest failure.
    from sdfs_via_autodiff_tpu.solvers import newton_solver
    model, grids = setup
    T = T_gcy_continuous_factory(model, grids, interp="pre", quad_degree=3)
    w0 = jnp.ones(SIZES)
    res = newton_solver(T, w0, tol=1e-9)
    assert bool(res.converged)
    assert float(res.x.min()) > 1

    res_unsafe = newton_solver(T, w0, tol=1e-9, safeguard=False)
    assert not bool(res_unsafe.converged)


def test_f32_coarse_baseline_driver():
    # The float32 production recipe: coarse f64 solve -> additive
    # baseline -> normalized f32 operator + warm start.  The plain f32
    # log-space operator overflows on these grids (theta*range ~ 200).
    from sdfs_via_autodiff_tpu import wc_ratio_continuous
    model = GCY()
    sol = wc_ratio_continuous(model, (8,) * 6, algorithm="anderson",
                              tol=5e-6, baseline="coarse",
                              dtype=jnp.float32, quad_degree=3)
    assert sol.converged, sol.result
    ref = wc_ratio_continuous(model, (8,) * 6, algorithm="newton",
                              tol=1e-10, quad_degree=3)
    rel = np.max(np.abs(np.asarray(sol.w_star, np.float64)
                        - np.asarray(ref.w_star))
                 / np.asarray(ref.w_star))
    assert rel < 1e-3


def test_f32_range_warning(setup):
    import warnings
    model, _ = setup
    grids32 = build_grid_gcy(model, *SIZES, dtype=jnp.float32)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        T_gcy_continuous_factory(model, grids32, interp="pre", space="log",
                                 quad_degree=3, dtype=jnp.float32)
    assert any("float32's exponential range" in str(w.message) for w in rec)
    # Normalized build does not warn.
    with warnings.catch_warnings(record=True) as rec2:
        warnings.simplefilter("always")
        T_gcy_continuous_factory(model, grids32, interp="pre", space="log",
                                 quad_degree=3, dtype=jnp.float32,
                                 baseline="loglinear")
    assert not any("exponential range" in str(w.message) for w in rec2)


def test_monte_carlo_log_space(setup, rng):
    # MC expectations on the gather path, log space (untested combo).
    model, grids = setup
    T_mc = T_gcy_continuous_factory(model, grids, method="monte_carlo",
                                    interp="post", mc_draw_size=500)
    T_mc_log = T_gcy_continuous_factory(model, grids, method="monte_carlo",
                                        interp="post", mc_draw_size=500,
                                        space="log")
    w = rand_w(rng, spread=0.02)
    np.testing.assert_allclose(
        np.exp(np.asarray(T_mc_log(jnp.log(w)))), np.asarray(T_mc(w)),
        rtol=1e-10)
