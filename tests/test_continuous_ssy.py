"""Continuous-state SSY operator tests: factorization exactness, interp
variants, log-space consistency, end-to-end solves."""

import jax.numpy as jnp
import numpy as np
import pytest

from sdfs_via_autodiff_tpu import SSY, build_grid_ssy, next_state_ssy
from sdfs_via_autodiff_tpu.operators.continuous_ssy import (
    T_ssy_continuous_factory)

SIZES = (4, 5, 6, 7)


@pytest.fixture(scope="module")
def setup():
    model = SSY()
    grids = build_grid_ssy(model, *SIZES)
    return model, grids


def rand_w(rng, scale=700.0, spread=0.1):
    return jnp.asarray(scale * np.exp(spread * rng.standard_normal(SIZES)))


@pytest.mark.fast


def test_next_state_matches_dynamics(setup, rng):
    model, _ = setup
    x = jnp.asarray(rng.standard_normal(4) * 0.01)
    eps = jnp.asarray(rng.standard_normal((4, 10)))
    out = next_state_ssy(model, x, eps)
    m = model
    np.testing.assert_allclose(out[0], m.rho_lam * x[0] + m.s_lam * eps[0])
    np.testing.assert_allclose(out[1], m.rho_c * x[1] + m.s_c * eps[1])
    np.testing.assert_allclose(out[2], m.rho_z * x[2] + m.s_z * eps[2])
    sigma_z = m.phi_z * np.exp(x[2])
    np.testing.assert_allclose(out[3], m.rho * x[3] + sigma_z * eps[3])


def test_factored_equals_gather_pre(setup, rng):
    # The per-axis factorization is EXACT for tensor-product quadrature of
    # the pre-power interpolant.
    model, grids = setup
    T_fac = T_ssy_continuous_factory(model, grids, interp="pre",
                                     quad_degree=4)
    # gather path with the same tensor rule, forced via make_gather_T
    from sdfs_via_autodiff_tpu.operators.continuous_common import make_gather_T
    from sdfs_via_autodiff_tpu.operators.continuous_ssy import (
        _log_kappa_ssy, next_state_ssy as ns)
    from sdfs_via_autodiff_tpu.ops.quadrature import tensor_quadrature_normal
    nodes, weights = tensor_quadrature_normal([4] * 4)
    T_gather = make_gather_T(
        lambda x, s: ns(model, x, s),
        lambda x: _log_kappa_ssy(model, x[1], x[3]),
        grids, jnp.asarray(nodes), jnp.asarray(weights),
        "pre", "w", None, model.beta, model.theta)
    w = rand_w(rng)
    np.testing.assert_allclose(np.asarray(T_fac(w)), np.asarray(T_gather(w)),
                               rtol=1e-11)


def test_post_and_pre_interp_close(setup, rng):
    # Different interpolation functional forms; must agree to O(grid error).
    model, grids = setup
    T_pre = T_ssy_continuous_factory(model, grids, interp="pre")
    T_post = T_ssy_continuous_factory(model, grids, interp="post")
    w = rand_w(rng, spread=0.02)
    a, b = np.asarray(T_pre(w)), np.asarray(T_post(w))
    assert np.max(np.abs(a - b) / np.abs(b)) < 0.05


def test_log_space_consistent_all_interps(setup, rng):
    model, grids = setup
    w = rand_w(rng)
    for interp in ("pre", "post", "loglin"):
        T = T_ssy_continuous_factory(model, grids, interp=interp)
        T_log = T_ssy_continuous_factory(model, grids, interp=interp,
                                         space="log")
        np.testing.assert_allclose(
            np.exp(np.asarray(T_log(jnp.log(w)))), np.asarray(T(w)),
            rtol=1e-11, err_msg=interp)


def test_monte_carlo_close_to_quadrature(setup, rng):
    model, grids = setup
    T_q = T_ssy_continuous_factory(model, grids, interp="post")
    T_mc = T_ssy_continuous_factory(model, grids, method="monte_carlo",
                                    interp="post", mc_draw_size=4000)
    w = rand_w(rng, spread=0.02)
    a, b = np.asarray(T_q(w)), np.asarray(T_mc(w))
    # Kg-level MC noise is tiny after the 1/theta compression.
    assert np.max(np.abs(a - b) / np.abs(a)) < 0.02


def test_batched_equals_unbatched(setup, rng):
    model, grids = setup
    n = int(np.prod(SIZES))
    T1 = T_ssy_continuous_factory(model, grids, interp="post")
    T2 = T_ssy_continuous_factory(model, grids, interp="post",
                                  batch_size=n // 4)
    w = rand_w(rng)
    np.testing.assert_allclose(np.asarray(T1(w)), np.asarray(T2(w)),
                               rtol=1e-12)


def test_bad_batch_size_raises(setup):
    model, grids = setup
    with pytest.raises(ValueError):
        T_ssy_continuous_factory(model, grids, interp="post", batch_size=11)(
            jnp.ones(SIZES))


def test_end_to_end_continuous_solve(setup):
    from sdfs_via_autodiff_tpu import wc_ratio_continuous
    model, _ = setup
    sol = wc_ratio_continuous(model, SIZES, algorithm="newton", tol=1e-9,
                              interp="pre")
    assert sol.converged
    w = np.asarray(sol.w_star)
    assert w.shape == SIZES
    assert np.all(w > 1)
    # Sanity vs the reference's observed magnitudes: w* is O(10^2-10^3).
    assert 100 < w.mean() < 3000


def test_interp_variants_converge_with_grid_refinement():
    # The pre/post interpolation forms differ by O(grid error) per operator
    # application (and the beta~1 fixed point amplifies that difference by
    # ~1/(1-beta) in levels — the same level sensitivity the reference
    # observed for its log-interpolation variant, test_newton.md:217-238).
    # Consistency check: the per-application gap shrinks as the grid is
    # refined, evaluated on a smooth w field.
    from sdfs_via_autodiff_tpu import ssy_loglinear_factory
    from sdfs_via_autodiff_tpu.ops.grids import flatten_mesh
    model = SSY()
    ll = ssy_loglinear_factory(model)

    def gap(sizes):
        grids = build_grid_ssy(model, *sizes)
        shape = tuple(len(g) for g in grids)
        w = jnp.exp(jnp.asarray(
            ll(np.asarray(flatten_mesh(grids)).T).reshape(shape)))
        a = T_ssy_continuous_factory(model, grids, interp="pre")(w)
        b = T_ssy_continuous_factory(model, grids, interp="post")(w)
        return float(jnp.max(jnp.abs(a - b) / jnp.abs(b)))

    coarse = gap((4, 4, 4, 5))
    fine = gap((10, 10, 10, 14))
    assert fine < coarse
    assert fine < 0.01


def test_existence_check_continuous(setup):
    from sdfs_via_autodiff_tpu.utils.spectral import existence_check
    model, grids = setup
    rep = existence_check(model, grids=grids)
    assert rep.exists_unique
    assert 0 < rep.spectral_radius
    # theta < 0: r(H)^(1/theta) < 1 requires r(H) > 1 here.
    assert rep.stability_exponent < 1


def test_polish_refines_f32_solve():
    # f32 fast solve -> f64 Newton polish: full accuracy with a warm
    # start that leaves only a few Newton steps.
    from sdfs_via_autodiff_tpu import wc_ratio_continuous
    model = SSY()
    sol = wc_ratio_continuous(model, (8, 8, 8, 10), algorithm="anderson",
                              tol=1e-9, dtype=jnp.float32, polish=True)
    assert sol.converged
    assert int(sol.result.iterations) <= 6
    ref = wc_ratio_continuous(model, (8, 8, 8, 10), algorithm="newton",
                              tol=1e-10)
    np.testing.assert_allclose(np.asarray(sol.w_star),
                               np.asarray(ref.w_star), atol=1e-6)


class TestCalibrationSweep:
    """wc_ratio_sweep: many calibrations, one compiled vmapped program."""

    def test_ssy_sweep_matches_individual_solves(self):
        import dataclasses

        from sdfs_via_autodiff_tpu import (SSY, wc_ratio_continuous,
                                           wc_ratio_sweep)
        models = [SSY(), dataclasses.replace(SSY(), gamma=7.5),
                  dataclasses.replace(SSY(), psi=1.5)]
        w, res, _ = wc_ratio_sweep(models, (6, 6, 6, 8), quad_degree=3,
                                   tol=1e-9)
        assert w.shape == (3, 6, 6, 6, 8)
        assert bool(jnp.all(res.converged))
        for i, m in enumerate(models):
            sol = wc_ratio_continuous(m, (6, 6, 6, 8), quad_degree=3,
                                      tol=1e-9, interp="pre", space="log")
            assert float(jnp.max(jnp.abs(w[i] - sol.w_star))) < 1e-6

    def test_gcy_sweep(self):
        import dataclasses

        from sdfs_via_autodiff_tpu import (GCY, wc_ratio_continuous,
                                           wc_ratio_sweep)
        models = [GCY(), dataclasses.replace(GCY(), gamma=12.0)]
        w, res, _ = wc_ratio_sweep(models, (3, 3, 3, 3, 4, 3),
                                   quad_degree=3, tol=1e-8,
                                   algorithm="successive_approx",
                                   max_iter=20000)
        assert bool(jnp.all(res.converged))
        sol = wc_ratio_continuous(GCY(), (3, 3, 3, 3, 4, 3),
                                  quad_degree=3, tol=1e-8, interp="pre",
                                  space="log")
        # SA at tol 1e-8 on the log iterate: the fixed-point
        # amplification 1/(1-rate) and w ~ 40 put the w-space agreement
        # at ~1e-5.
        assert float(jnp.max(jnp.abs(w[0] - sol.w_star))) < 5e-5

    def test_sweep_rejects_mixed_families(self):
        from sdfs_via_autodiff_tpu import GCY, SSY, wc_ratio_sweep
        with pytest.raises(ValueError, match="one model family"):
            wc_ratio_sweep([SSY(), GCY()], (4, 4, 4, 4))


def test_engine_gather_is_honored_on_pre_path(rng):
    # engine='gather' + interp='pre' must dispatch the pointwise gather
    # oracle (previously the factored branch caught the combination
    # first and the 'cross-check' trivially compared the factored chain
    # with itself).  The two paths agree because interp='pre'
    # quadrature is exact algebraic refactoring — which is only a
    # meaningful statement when they are different programs.
    model = SSY()
    grids = build_grid_ssy(model, 4, 4, 4, 5)
    T_fact = T_ssy_continuous_factory(model, grids, interp="pre",
                                      space="log", quad_degree=3)
    T_gath = T_ssy_continuous_factory(model, grids, interp="pre",
                                      space="log", quad_degree=3,
                                      engine="gather")
    ell = jnp.asarray(np.log(800.0)
                      + 0.05 * rng.standard_normal((4, 4, 4, 5)))
    np.testing.assert_allclose(np.asarray(T_gath(ell)),
                               np.asarray(T_fact(ell)), atol=1e-9)
    with pytest.raises(ValueError, match="node_chain"):
        T_ssy_continuous_factory(model, grids, interp="pre",
                                 space="log", engine="node_chain")
