"""Solver unit tests on analytically-solvable fixed-point problems."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdfs_via_autodiff_tpu.solvers import (
    SolveResult, anderson_solver, gradient_solver, newton_solver, solve,
    solver, successive_approx)

# Affine contraction T(x) = A x + b with ||A|| < 1: unique fixed point
# x* = (I - A)^{-1} b.
A = jnp.asarray(np.array([[0.5, 0.2], [0.1, 0.6]]))
B = jnp.asarray(np.array([1.0, 2.0]))
X_STAR = jnp.linalg.solve(jnp.eye(2) - A, B)


def affine(x):
    return A @ x + B


def test_successive_approx():
    res = successive_approx(affine, jnp.zeros(2), tol=1e-12)
    assert isinstance(res, SolveResult)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(X_STAR),
                               atol=1e-10)
    assert int(res.iterations) > 10   # plain iteration is slow


def test_newton_one_shot_on_affine():
    # Newton solves an affine problem in a single outer iteration.
    res = newton_solver(affine, jnp.zeros(2), tol=1e-10)
    assert bool(res.converged)
    assert int(res.iterations) <= 2
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(X_STAR),
                               atol=1e-8)


@pytest.mark.parametrize("inner", ["bicgstab", "gmres", "dense"])
def test_newton_inner_variants(inner):
    res = newton_solver(affine, jnp.zeros(2), tol=1e-10, inner=inner)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(X_STAR),
                               atol=1e-8)


def test_newton_nonlinear():
    # Scalar-ish nonlinear map: T(x) = sqrt(2 + x) elementwise, fixed point 2.
    T = lambda x: jnp.sqrt(2.0 + x)
    res = newton_solver(T, jnp.full(3, 10.0), tol=1e-12)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), 2.0, atol=1e-10)


def test_anderson():
    res = anderson_solver(affine, jnp.zeros(2), tol=1e-10, beta=1.0,
                          warmup=2, history_size=4, mixing_frequency=1)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(X_STAR),
                               atol=1e-8)
    # AA on an affine problem should beat plain iteration decisively.
    plain = successive_approx(affine, jnp.zeros(2), tol=1e-10)
    assert int(res.iterations) < int(plain.iterations)


def test_gradient_solver():
    res = gradient_solver(affine, jnp.zeros(2), tol=1e-6, max_iter=500)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(X_STAR),
                               atol=1e-4)


def test_nan_guard_stops():
    def diverge(x):
        return x * jnp.nan

    res = successive_approx(diverge, jnp.ones(2), tol=1e-10, max_iter=100)
    assert not bool(res.converged)
    assert int(res.iterations) < 100   # stopped early on NaN, not max_iter


def test_max_iter_cap():
    slow = lambda x: 0.99999 * x + 0.1
    res = successive_approx(slow, jnp.zeros(2), tol=1e-14, max_iter=50)
    assert not bool(res.converged)
    assert int(res.iterations) == 50


def test_trace_recording():
    res = successive_approx(affine, jnp.zeros(2), tol=1e-10, trace_len=16)
    t = np.asarray(res.error_trace)
    assert t.shape == (16,)
    valid = t[~np.isnan(t)]
    assert len(valid) >= 5
    assert np.all(np.diff(valid[:5]) < 0)   # contraction: decreasing errors


def test_solve_front_end_unknown_method():
    with pytest.raises(ValueError):
        solve(affine, jnp.zeros(2), method="nope")


def test_reference_compat_solver_shim():
    # Unknown algorithm falls back to successive approximation with a
    # warning (reference code/solvers.py:164-171) and returns the array.
    with pytest.warns(UserWarning):
        x = solver(affine, jnp.zeros(2), algorithm="definitely_not_a_solver",
                   verbose=False)
    np.testing.assert_allclose(np.asarray(x), np.asarray(X_STAR), atol=1e-6)


def test_jvp_through_operator():
    # Autodiff differentiates straight through a solver-facing closure —
    # the contract the reference's Newton relies on (solvers.py:87).
    g = lambda x: affine(x) - x
    v = jnp.asarray([1.0, -1.0])
    _, jv = jax.jvp(g, (jnp.zeros(2),), (v,))
    np.testing.assert_allclose(np.asarray(jv), np.asarray((A - jnp.eye(2)) @ v),
                               atol=1e-12)


def test_timed_solve_utility():
    from sdfs_via_autodiff_tpu.solvers import successive_approx
    from sdfs_via_autodiff_tpu.utils.profiling import timed_solve
    ts = timed_solve(successive_approx, affine, jnp.zeros(2), tol=1e-10)
    assert bool(ts.result.converged)
    assert ts.wall_seconds > 0
    assert ts.points_per_second > 0
    assert "point-updates/s" in str(ts)


def test_checkpoint_version_guard(tmp_path):
    import numpy as onp
    from sdfs_via_autodiff_tpu import SSY
    from sdfs_via_autodiff_tpu.utils.checkpoint import (
        load_solution, save_solution)
    path = str(tmp_path / "v.npz")
    save_solution(path, SSY(), (jnp.linspace(0, 1, 3),), jnp.ones(3))
    # Corrupt the version upward: loader must refuse.
    data = dict(onp.load(path, allow_pickle=False))
    data["version"] = onp.int64(99)
    onp.savez_compressed(path, **data)
    with pytest.raises(ValueError):
        load_solution(path)


def test_mesh_validation_errors():
    from sdfs_via_autodiff_tpu.parallel.mesh import make_mesh
    import jax
    with pytest.raises(ValueError):
        make_mesh(jax.device_count() + 1)


def test_stall_guard_stops_limit_cycle():
    # T(x) = 1 - x limit-cycles between 0 and 1: the residual never
    # improves, and without the plateau guard the loop would spin for the
    # full max_iter as one long device loop.
    import jax.numpy as jnp

    from sdfs_via_autodiff_tpu.solvers.fixed_point import (STALL_ITERS,
                                                           successive_approx)
    T = lambda x: 1.0 - x
    res = successive_approx(T, jnp.zeros((4,)), tol=1e-12,
                            max_iter=1_000_000)
    assert not bool(res.converged)
    assert int(res.iterations) <= STALL_ITERS + 2


def test_stall_guard_does_not_trip_slow_contraction():
    # A rate-0.999 contraction (beta-like) improves ~1e-3 per iteration —
    # far above STALL_RTOL — and must run to convergence.
    import jax.numpy as jnp

    from sdfs_via_autodiff_tpu.solvers.fixed_point import successive_approx
    T = lambda x: 0.999 * x
    res = successive_approx(T, jnp.ones((4,)), tol=1e-8, max_iter=100_000)
    assert bool(res.converged)


def test_newton_zero_step_is_not_convergence():
    # A degenerate inner solve (here: an absurd forcing tolerance that
    # makes the zero vector an acceptable Krylov solution) collapses the
    # Newton step to zero far from the fixed point.  The result must
    # report the TRUE operator residual and converged=False — observed
    # where float32 BiCGStab breakdown at ~10^7 points faked residual
    # 0.0 at a point with true residual ~1e-2.
    from sdfs_via_autodiff_tpu.solvers.fixed_point import newton_solver
    A = jnp.asarray(np.diag([0.5, 0.4, 0.3]))
    b = jnp.ones(3)
    T = lambda x: A @ x + b
    x0 = jnp.zeros(3)
    res = newton_solver(T, x0, tol=1e-10, inner_tol=1e30, max_iter=5)
    assert not bool(res.converged)
    assert float(res.residual) > 1e-3
    # A healthy inner solve still converges and reports the operator
    # residual.
    ok = newton_solver(T, x0, tol=1e-10)
    assert bool(ok.converged) and float(ok.residual) <= 1e-10


def test_anderson_residual_belongs_to_returned_point():
    # The loop's carried x is one step ahead of the stopping residual
    # (possibly an unverified AA extrapolation); the result contract is
    # that ``residual`` is the true residual OF ``x``.
    from sdfs_via_autodiff_tpu import SSY, T_ssy_factory, discretize_ssy

    model = SSY()
    disc = discretize_ssy(model, (5, 5, 5, 5))
    T = T_ssy_factory(model, disc, space="log")
    res = solve(T, jnp.full((5, 5, 5, 5), jnp.log(800.0)),
                method="anderson", tol=1e-10)
    assert res.converged
    true_r = float(jnp.max(jnp.abs(T(res.x) - res.x)))
    np.testing.assert_allclose(true_r, float(res.residual), rtol=1e-10)


def test_newton_dense_safeguard_from_hostile_start():
    # inner="dense" honours the safeguard contract: a far-from-solution
    # start whose raw Newton step would leave the domain converges via
    # the plain-step fallback instead of returning NaN.
    from sdfs_via_autodiff_tpu import SSY, T_ssy_factory, discretize_ssy

    model = SSY()
    disc = discretize_ssy(model, (3, 3, 3, 3))
    T = T_ssy_factory(model, disc)
    res = solve(T, jnp.full((3, 3, 3, 3), 2.0), method="newton",
                inner="dense", tol=1e-11)
    assert res.converged and bool(jnp.all(jnp.isfinite(res.x)))


def test_newton_tangent_T_iterative_refinement():
    # Mixed-precision iterative refinement (newton_solver(tangent_T=)):
    # the f64 operator supplies residual + safeguard, the f32 twin's
    # linearization supplies the inner Krylov matvecs — the solve still
    # reaches f64 accuracy and the f64-tangent solution.
    from sdfs_via_autodiff_tpu import SSY, T_ssy_factory, discretize_ssy

    model = SSY()
    shapes = (6, 6, 6, 6)
    disc = discretize_ssy(model, shapes)
    T64 = T_ssy_factory(model, disc, space="log")
    T32 = T_ssy_factory(model, disc, space="log", dtype=jnp.float32)
    x0 = jnp.full(shapes, jnp.log(800.0))
    ref = solve(T64, x0, method="newton", tol=1e-12)
    res = solve(T64, x0, method="newton", tol=1e-12, tangent_T=T32)
    assert bool(res.converged)
    assert float(res.residual) <= 1e-12
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               atol=1e-10)


def test_iterate_nonfinite_step_returns_last_finite():
    # A step that overflows f32 to inf mid-iteration: the device loop
    # must stop on the non-finite step and return the last FINITE
    # iterate (the 18.9M pair-SA failure class: an f32-envelope exit
    # shows up as inf, which isnan() alone loops straight through,
    # poisoning the returned field).
    def T(x):
        return x * jnp.asarray(1e4, jnp.float32)

    x0 = jnp.full((8,), 1e30, jnp.float32)
    res = solve(T, x0, method="sa", tol=1e-12, max_iter=50)
    assert not bool(res.converged)
    assert bool(jnp.all(jnp.isfinite(res.x)))
    assert bool(jnp.isfinite(res.residual))
