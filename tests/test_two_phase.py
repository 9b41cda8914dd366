"""Two-phase operand sets and their plain evaluator (``make_xla_two_phase_T``).

Oracle: the f64 per-axis operators (``T_ssy_factory``,
``T_ssy_continuous_factory``, ``T_gcy_factory``,
``T_gcy_continuous_factory``), which are themselves validated against loop
oracles and dense H.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sdfs_via_autodiff_tpu import SSY, discretize_ssy, T_ssy_factory, solve
from sdfs_via_autodiff_tpu.operators.continuous_ssy import (
    T_ssy_continuous_factory, build_grid_ssy)
from sdfs_via_autodiff_tpu.operators.two_phase import (
    make_xla_two_phase_T, two_phase_operands_ssy,
    two_phase_operands_ssy_continuous)

SHAPES = (4, 5, 6, 7)


def _rand_ell(shapes, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return jnp.asarray(np.log(800.0) + scale * rng.standard_normal(shapes))


@pytest.fixture(scope="module")
def ssy_disc():
    model = SSY()
    return model, discretize_ssy(model, SHAPES)


class TestDiscreteSSY:
    def test_xla_twin_matches_reference_operator(self, ssy_disc):
        model, disc = ssy_disc
        ops = two_phase_operands_ssy(model, disc)
        T_ref = T_ssy_factory(model, disc, space="log")
        T_two = make_xla_two_phase_T(ops, dtype=jnp.float64)
        ell = _rand_ell(SHAPES)
        np.testing.assert_allclose(T_two(ell), T_ref(ell), rtol=1e-12)

    def test_xla_twin_normalized_matches(self, ssy_disc):
        model, disc = ssy_disc
        ops = two_phase_operands_ssy(model, disc, baseline="loglinear")
        T_ref = T_ssy_factory(model, disc, space="log",
                              baseline="loglinear", dtype=jnp.float64)
        T_two = make_xla_two_phase_T(ops, dtype=jnp.float64)
        ell = _rand_ell(SHAPES)
        np.testing.assert_allclose(T_two(ell), T_ref(ell), rtol=1e-11)

    def test_newton_through_twin_matches_reference_solution(self, ssy_disc):
        model, disc = ssy_disc
        T_two = make_xla_two_phase_T(two_phase_operands_ssy(model, disc),
                                     dtype=jnp.float64)
        T_ref = T_ssy_factory(model, disc, space="log")
        ell0 = jnp.full(SHAPES, jnp.log(800.0))
        got = solve(T_two, ell0, method="newton", tol=1e-10)
        ref = solve(T_ref, ell0, method="newton", tol=1e-10)
        assert bool(got.converged)
        np.testing.assert_allclose(got.x, ref.x, rtol=0, atol=1e-9)


class TestContinuousSSY:
    @pytest.fixture(scope="class")
    def grids(self):
        return build_grid_ssy(SSY(), 4, 5, 6, 7, num_std_devs=3.2)

    def test_xla_twin_matches_factored_operator(self, grids):
        model = SSY()
        ops = two_phase_operands_ssy_continuous(model, grids, degree=5)
        T_ref = T_ssy_continuous_factory(model, grids, method="quadrature",
                                         interp="pre", space="log")
        T_two = make_xla_two_phase_T(ops, dtype=jnp.float64)
        ell = _rand_ell(SHAPES)
        np.testing.assert_allclose(T_two(ell), T_ref(ell), rtol=1e-12)


class TestGCYKron:
    """Six-state GCY folded into the 4-D two-phase structure by
    Kronecker grouping (rows h_c / h_lam, columns z (x) z_pi /
    h_z (x) h_zpi)."""

    SHAPES = (4, 3, 3, 4, 3, 5)

    def test_kron_twin_matches_chain(self, rng):
        from sdfs_via_autodiff_tpu import GCY, discretize_gcy
        from sdfs_via_autodiff_tpu.operators.discrete_gcy import T_gcy_factory
        from sdfs_via_autodiff_tpu.operators.two_phase import (
            two_phase_operands_gcy)
        model = GCY()
        disc = discretize_gcy(model, self.SHAPES)
        ops = two_phase_operands_gcy(model, disc)
        T_twin = make_xla_two_phase_T(ops, jnp.float64)
        T_ref = T_gcy_factory(model, disc, space="log", jit=False)
        ell = jnp.asarray(np.log(300.0)
                          + 0.1 * rng.standard_normal(self.SHAPES))
        view_shapes = tuple(self.SHAPES[p] for p in ops.perm)
        got = jnp.transpose(
            T_twin(jnp.transpose(ell, ops.perm).reshape(ops.shapes))
            .reshape(view_shapes), ops.inv_perm)
        np.testing.assert_allclose(np.asarray(got), np.asarray(T_ref(ell)),
                                   atol=1e-11, rtol=0)


class TestGCYNormalized:
    """Baseline-normalized GCY folded into the two-phase grouping: the
    log-linear baseline conjugates into shared row factors + rank-2
    batched column factors (the z chain's sigma_z scale AND z_pi mean
    shift), exact vs both the per-axis normalized chain and the plain
    operator."""

    SHAPES = (6, 5, 4, 3, 4, 3)

    @pytest.fixture(scope="class", params=["rouwenhorst", "tauchen"])
    def gcy_norm(self, request):
        from sdfs_via_autodiff_tpu import GCY, discretize_gcy
        from sdfs_via_autodiff_tpu.operators.two_phase import (
            two_phase_operands_gcy)
        model = GCY()
        disc = discretize_gcy(model, self.SHAPES, method=request.param)
        ops = two_phase_operands_gcy(model, disc, baseline="loglinear")
        return model, disc, ops

    def _natural(self, ops, out_v):
        view_shapes = tuple(self.SHAPES[p] for p in ops.perm)
        return jnp.transpose(out_v.reshape(view_shapes), ops.inv_perm)

    def test_twin_matches_plain_and_normalized_chain(self, gcy_norm, rng):
        from sdfs_via_autodiff_tpu.operators.discrete_gcy import (
            T_gcy_factory)
        model, disc, ops = gcy_norm
        assert ops.c1_batched and ops.c2_batched and ops.has_sub
        T64 = make_xla_two_phase_T(ops, jnp.float64)
        Tn = T_gcy_factory(model, disc, space="log", baseline="loglinear",
                           dtype=jnp.float64, jit=False)
        Tp = T_gcy_factory(model, disc, space="log", dtype=jnp.float64,
                           jit=False)
        ell = jnp.asarray(np.log(300.0)
                          + 0.3 * rng.standard_normal(self.SHAPES))
        got = self._natural(
            ops, T64(jnp.transpose(ell, ops.perm).reshape(ops.shapes)))
        np.testing.assert_allclose(np.asarray(got), np.asarray(Tn(ell)),
                                   atol=1e-12, rtol=0)
        np.testing.assert_allclose(np.asarray(got), np.asarray(Tp(ell)),
                                   atol=1e-12, rtol=0)

    def test_fold_accepts_f32_built_grids(self, rng):
        # An f32-built discretization rounds the (truly separable)
        # z ladder by ~eps(f32); the fold's separability check is
        # dtype-aware, and accepting it is exact — the rank-2
        # reconstruction g is used consistently in both sub and add
        # corrections, so the operator value is baseline-independent.
        from sdfs_via_autodiff_tpu import GCY, discretize_gcy
        from sdfs_via_autodiff_tpu.operators.discrete_gcy import (
            T_gcy_factory)
        from sdfs_via_autodiff_tpu.operators.two_phase import (
            two_phase_operands_gcy)
        model = GCY()
        ell = jnp.asarray(np.log(300.0)
                          + 0.3 * rng.standard_normal(self.SHAPES))
        for method in ("rouwenhorst", "tauchen"):
            disc32 = discretize_gcy(model, self.SHAPES,
                                    dtype=jnp.float32, method=method)
            ops = two_phase_operands_gcy(model, disc32,
                                         baseline="loglinear")
            T64 = make_xla_two_phase_T(ops, jnp.float64)
            Tp = T_gcy_factory(model, disc32, space="log",
                               dtype=jnp.float64, jit=False)
            got = self._natural(
                ops, T64(jnp.transpose(ell, ops.perm).reshape(ops.shapes)))
            np.testing.assert_allclose(np.asarray(got),
                                       np.asarray(Tp(ell)),
                                       atol=1e-9, rtol=0)

class TestContinuousGCYPair:
    """Continuous six-state GCY, whose conditioned z/z_pi expectation
    matrices (P_z on current h_z AND z_pi, P_zpi on current h_zpi)
    contract per slice in the column phase."""

    GSHAPES = (4, 3, 2, 4, 8, 2)

    def test_twin_matches_factored_chain_f64(self):
        from sdfs_via_autodiff_tpu import GCY, build_grid_gcy
        from sdfs_via_autodiff_tpu.operators.continuous_gcy import (
            T_gcy_continuous_factory)
        from sdfs_via_autodiff_tpu.operators.two_phase import (
            two_phase_operands_gcy_continuous)
        model = GCY()
        grids = build_grid_gcy(model, *self.GSHAPES)
        ops = two_phase_operands_gcy_continuous(model, grids, degree=5,
                                                baseline="loglinear")
        Ttwin = make_xla_two_phase_T(ops, dtype=jnp.float64)
        T_ref = T_gcy_continuous_factory(
            model, grids, method="quadrature", interp="pre", space="log",
            quad_degree=5, baseline="loglinear", jit=False)
        ell = _rand_ell(self.GSHAPES, scale=0.05)
        view = jnp.transpose(ell, ops.perm).reshape(ops.shapes)
        out = jnp.transpose(
            Ttwin(view).reshape([self.GSHAPES[p] for p in ops.perm]),
            ops.inv_perm)
        np.testing.assert_allclose(np.asarray(out),
                                   np.asarray(T_ref(ell)), atol=1e-12)


class TestTwinPrecisionTiers:
    """The "3x" (bf16 hi/lo split) precision tier of the twin and of
    ``lse_matmul``."""

    def test_twin_3x_close_to_highest_and_f64_guarded(self, ssy_disc):
        model, disc = ssy_disc
        ops = two_phase_operands_ssy(model, disc)
        x = jnp.asarray(_rand_ell(SHAPES), jnp.float32)
        hi = make_xla_two_phase_T(ops, jnp.float32)(x)
        x3 = make_xla_two_phase_T(ops, jnp.float32, precision="3x")(x)
        assert float(jnp.max(jnp.abs(hi - x3))) < 2e-5
        # float64 operands must never take the bf16-split path.
        f64 = make_xla_two_phase_T(ops, jnp.float64, precision="3x")(x)
        f64h = make_xla_two_phase_T(ops, jnp.float64)(x)
        np.testing.assert_array_equal(np.asarray(f64), np.asarray(f64h))

    def test_newton_through_3x_twin(self, ssy_disc):
        model, disc = ssy_disc
        ops = two_phase_operands_ssy(model, disc)
        T = make_xla_two_phase_T(ops, jnp.float32, precision="3x")
        res = solve(T, jnp.full(SHAPES, jnp.log(800.0), jnp.float32),
                    method="newton", tol=2e-5)
        assert bool(res.converged)

    def test_lse_matmul_precision_tiers(self):
        from sdfs_via_autodiff_tpu.ops.contract import lse_matmul
        rng = np.random.default_rng(3)
        a = jnp.asarray(rng.standard_normal((8, 16, 32)), jnp.float32)
        M = jnp.asarray(np.abs(rng.standard_normal((16, 16))), jnp.float32)
        hi = lse_matmul(M, a, "im,tmj->tij", 1)
        x3 = lse_matmul(M, a, "im,tmj->tij", 1, precision="3x")
        assert float(jnp.max(jnp.abs(hi - x3))) < 5e-5
        with pytest.raises(ValueError):
            lse_matmul(M, a, "im,tmj->tij", 1, precision="nope")


def test_anderson_nan_stop_returns_best_finite_iterate():
    """An Anderson combination that leaves the f32 operator's exp
    envelope poisons the next iterate with NaN; the solver must stop AND
    return the best finite iterate and its residual, not the poisoned
    point.  Deterministic scenario: the continuous-GCY f32 twin under
    the log-linear fold, whose true solution sits ~2.6 log units from
    the baseline (theta * span ~ 95 > exp's f32 range)."""
    from sdfs_via_autodiff_tpu import GCY, build_grid_gcy
    from sdfs_via_autodiff_tpu.operators.two_phase import (
        two_phase_operands_gcy_continuous)
    model = GCY()
    grids = build_grid_gcy(model, 8, 3, 2, 4, 128, 2)
    ops = two_phase_operands_gcy_continuous(model, grids, degree=5,
                                            baseline="loglinear")
    T32 = make_xla_two_phase_T(ops, dtype=jnp.float32)
    res = solve(T32, jnp.asarray(ops.baseline_log_w, jnp.float32),
                method="anderson", tol=2e-4, max_iter=400)
    assert not bool(res.converged)
    assert bool(jnp.isfinite(res.x).all())
    assert np.isfinite(float(res.residual))
