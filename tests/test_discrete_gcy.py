"""Discrete GCY operator: oracle, dense-H, log-space, and end-to-end tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from sdfs_via_autodiff_tpu import (
    GCY, T_gcy_factory, dense_H_gcy, discretize_gcy, solve)
from oracles import T_gcy_oracle

# (n_z, n_z_pi, n_h_z, n_h_c, n_h_zpi, n_h_lam) — tiny for the oracle.
SHAPES = (3, 2, 2, 3, 2, 2)


@pytest.fixture(scope="module")
def setup():
    model = GCY()
    disc = discretize_gcy(model, SHAPES)
    return model, disc


def test_discretization_layout(setup):
    model, disc = setup
    n_z, n_z_pi, n_h_z, n_h_c, n_h_zpi, n_h_lam = SHAPES
    assert disc.z_pi_states.shape == (n_h_zpi, n_z_pi)
    assert disc.z_states.shape == (n_z_pi, n_h_z, n_h_zpi, n_z)
    arrays = disc.as_reference_tuple()
    assert len(arrays) == 15
    assert arrays[1].shape == (n_z_pi, n_h_z, n_h_zpi, n_z, n_z)  # z_Q
    assert arrays[3].shape == (n_h_zpi, n_z_pi, n_z_pi)           # z_pi_Q
    # z grid centers shift with rho_pi * z_pi / (1 - rho).
    centers = np.asarray(disc.z_states).mean(axis=-1)
    expected = (model.rho_pi / (1 - model.rho)) * np.asarray(disc.z_pi_states).T[:, None, :]
    np.testing.assert_allclose(centers, np.broadcast_to(expected, centers.shape),
                               atol=1e-12)


def test_factored_matches_loop_oracle(setup, rng):
    model, disc = setup
    T = T_gcy_factory(model, disc)
    w = jnp.asarray(np.exp(rng.standard_normal(SHAPES)))
    np.testing.assert_allclose(np.asarray(T(w)),
                               T_gcy_oracle(w, model, disc), rtol=1e-10)


def test_factored_matches_dense_H(setup, rng):
    model, disc = setup
    T = T_gcy_factory(model, disc)
    H = dense_H_gcy(model, disc)
    theta, beta = model.theta, model.beta
    w = jnp.asarray(np.exp(rng.standard_normal(SHAPES)))
    via_dense = 1 + beta * (H @ (w.reshape(-1) ** theta)) ** (1 / theta)
    np.testing.assert_allclose(np.asarray(T(w)).ravel(),
                               np.asarray(via_dense), rtol=1e-10)


def test_log_space_consistent(setup, rng):
    model, disc = setup
    T = T_gcy_factory(model, disc)
    T_log = T_gcy_factory(model, disc, space="log")
    w = jnp.asarray(np.exp(rng.standard_normal(SHAPES))) * 500
    np.testing.assert_allclose(np.exp(np.asarray(T_log(jnp.log(w)))),
                               np.asarray(T(w)), rtol=1e-12)


@pytest.mark.parametrize("method", ["successive_approx", "newton", "anderson"])
def test_end_to_end_solve(setup, method):
    model, disc = setup
    T = T_gcy_factory(model, disc)
    w0 = jnp.full(SHAPES, 800.0)   # reference init, gcy_wc_ratio.py:336-337
    res = solve(T, w0, method=method, tol=1e-7)
    assert bool(res.converged), f"{method} did not converge: {res}"
    np.testing.assert_allclose(np.asarray(T(res.x)), np.asarray(res.x),
                               atol=2e-7)


def test_solvers_agree(setup):
    model, disc = setup
    T = T_gcy_factory(model, disc)
    w0 = jnp.full(SHAPES, 800.0)
    w_succ = solve(T, w0, method="successive_approx", tol=1e-10).x
    w_newt = solve(T, w0, method="newton", tol=1e-10).x
    np.testing.assert_allclose(np.asarray(w_succ), np.asarray(w_newt),
                               atol=1e-7)


def test_normalized_operator_matches_plain(setup, rng):
    model, disc = setup
    T_plain = T_gcy_factory(model, disc, space="log")
    T_norm = T_gcy_factory(model, disc, space="log", baseline="loglinear",
                           dtype=jnp.float64)
    ell = jnp.asarray(np.asarray(T_norm.baseline_log_w)
                      + 0.05 * rng.standard_normal(SHAPES))
    np.testing.assert_allclose(np.asarray(T_norm(ell)),
                               np.asarray(T_plain(ell)), atol=1e-11)
    res_n = solve(T_norm, T_norm.baseline_log_w, method="newton", tol=1e-11)
    res_p = solve(T_plain, jnp.full(SHAPES, jnp.log(800.0)), method="newton",
                  tol=1e-11)
    assert bool(res_n.converged)
    np.testing.assert_allclose(np.asarray(res_n.x), np.asarray(res_p.x),
                               atol=1e-9)


def test_normalized_f32_wide_grid_stays_finite():
    model = GCY()
    disc = discretize_gcy(model, (40, 3, 3, 3, 3, 3), dtype=jnp.float32)
    T = T_gcy_factory(model, disc, space="log", baseline="loglinear",
                      dtype=jnp.float32)
    ell = T.baseline_log_w
    for _ in range(25):
        ell = T(ell)
    assert bool(jnp.all(jnp.isfinite(ell)))


def test_normalized_f32_wide_ladder_first_app_and_f64_agreement():
    # The 25.2M north-star widths scaled down: z = 32 Rouwenhorst with
    # the conditioned factor folds whose plain-f32 cast used to make
    # inf rowsums -> NaN (round-5 fix: log-domain row normalization at
    # construction + lse_matmul deep_window).
    model = GCY()
    disc = discretize_gcy(model, (32, 8, 8, 3, 4, 4), dtype=jnp.float32)
    T32 = T_gcy_factory(model, disc, space="log", baseline="loglinear",
                        dtype=jnp.float32)
    x0 = jnp.asarray(T32.baseline_log_w, jnp.float32)
    y = T32(x0)
    assert bool(jnp.all(jnp.isfinite(y)))
    disc64 = discretize_gcy(model, (32, 8, 8, 3, 4, 4))
    T64 = T_gcy_factory(model, disc64, space="log", baseline="loglinear")
    y64 = T64(jnp.asarray(x0, jnp.float64))
    assert float(jnp.max(jnp.abs(jnp.asarray(y, jnp.float64) - y64))) < 1e-4


def test_existence_check_gcy(setup):
    from sdfs_via_autodiff_tpu.utils.spectral import existence_check
    model, disc = setup
    rep = existence_check(model, disc)
    H = np.asarray(dense_H_gcy(model, disc))
    r_dense = float(np.max(np.abs(np.linalg.eigvals(H))))
    np.testing.assert_allclose(rep.spectral_radius, r_dense, rtol=1e-7)
    assert rep.exists_unique


def test_gcy_tauchen_discretization_solves():
    # discretization="tauchen" flows through the driver; fixed-span grids
    # are the f32-range-safe choice for fine six-state grids.
    from sdfs_via_autodiff_tpu import GCY
    from sdfs_via_autodiff_tpu.drivers import wc_ratio_discrete
    sol = wc_ratio_discrete(GCY(), (4, 3, 3, 4, 3, 4), algorithm="newton",
                            tol=1e-9, discretization="tauchen")
    assert sol.converged
    import numpy as np
    w = np.asarray(sol.w_star)
    assert np.all(w > 1.0) and np.all(np.isfinite(w))


@pytest.mark.slow


def test_wide_rouwenhorst_f32_via_normalized_xla_chain():
    # The f32 range cap on wide Rouwenhorst GCY grids is a property of
    # joint column-group shifts, not of the operator — the normalized
    # per-axis chain converges in f32 on grids far beyond the Kronecker
    # envelope and tracks the f64 solution (the correctness oracle at CI
    # scale).
    from sdfs_via_autodiff_tpu.operators.discrete_gcy import (
        gcy_loglinear_parts)
    m = GCY()
    shapes = (16, 6, 8, 4, 6, 6)
    disc = discretize_gcy(m, shapes)
    ell0 = jnp.asarray(gcy_loglinear_parts(m, disc)["ell0"])
    T64 = T_gcy_factory(m, disc, space="log", baseline="loglinear")
    r64 = solve(T64, ell0, method="newton", tol=1e-10)
    T32 = T_gcy_factory(m, disc, space="log", baseline="loglinear",
                        dtype=jnp.float32)
    r32 = solve(T32, jnp.asarray(ell0, jnp.float32), method="newton",
                tol=3e-5)
    assert bool(r32.converged)
    sup = float(jnp.max(jnp.abs(jnp.asarray(r32.x, jnp.float64) - r64.x)))
    # ~1e-4 is the documented f32 solution-fidelity scale (per-app bias
    # x fixed-point amplification); the guarded failure mode (f32 grid
    # ladders perturbing the model) is ~1e-2.
    assert sup < 3e-4, sup


def test_driver_discretizes_in_f64_for_f32_operator():
    # dtype selects the operator working precision only; the grid
    # ladders stay f64 (f32 ladders perturb the model itself).
    from sdfs_via_autodiff_tpu import wc_ratio_discrete
    m = GCY()
    shapes = (4, 4, 4, 4, 4, 4)
    sol32 = wc_ratio_discrete(m, shapes, algorithm="newton", tol=3e-5,
                              dtype=jnp.float32, baseline="loglinear")
    sol64 = wc_ratio_discrete(m, shapes, algorithm="newton", tol=1e-10)
    assert sol32.converged and sol64.converged
    rel = np.max(np.abs(np.asarray(sol32.w_star, np.float64)
                        - np.asarray(sol64.w_star))
                 / np.asarray(sol64.w_star))
    assert rel < 3e-4, rel


def test_stability_decomposition_exact_gcy(setup):
    from sdfs_via_autodiff_tpu.utils.spectral import stability_decomposition
    model, disc = setup
    dec = stability_decomposition(model, disc)
    np.testing.assert_allclose(dec.S, dec.S_direct, atol=1e-8)
    assert dec.exists_unique
