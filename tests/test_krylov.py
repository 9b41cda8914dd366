"""Mixed-precision BiCGStab (solvers/krylov.py).

The point of the mixed scheme: float32 VECTORS (all the memory and matvec
cost) with float64 recurrence scalars and dot products, so the inner
Newton solve survives grid sizes where vector-dtype BiCGStab's scalar
ratios drown in f32 reduction noise and collapse to a zero step
(observed on a 25M-point GCY grid).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdfs_via_autodiff_tpu.solvers.krylov import bicgstab_mixed


def _true_residual(matvec, b, x):
    x64 = np.asarray(x, np.float64)
    return float(np.max(np.abs(np.asarray(b, np.float64)
                               - np.asarray(matvec(x64), np.float64))))


class TestBicgstabMixed:
    @pytest.mark.fast
    def test_matches_direct_solve_f64(self, rng):
        n = 40
        A = np.eye(n) + 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
        b = rng.standard_normal(n)
        mv = lambda v: jnp.asarray(A) @ v
        x, it = bicgstab_mixed(mv, jnp.asarray(b), atol=1e-12, maxiter=200)
        np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                                   atol=1e-9)
        assert int(it) < 200

    @pytest.mark.fast

    def test_f32_vectors_f64_scalars(self, rng):
        n = 64
        A = np.eye(n) + 0.2 * rng.standard_normal((n, n)) / np.sqrt(n)
        b = rng.standard_normal(n).astype(np.float32)
        mv = lambda v: (jnp.asarray(A, jnp.float32) @ v.astype(jnp.float32)
                        ).astype(v.dtype)
        x, _ = bicgstab_mixed(mv, jnp.asarray(b), atol=1e-5, maxiter=200)
        assert x.dtype == jnp.float32
        assert _true_residual(lambda v: A @ v, b, x) < 2e-5

    def test_shape_preserving(self, rng):
        # Newton feeds grid-shaped fields, not flat vectors.
        shape = (4, 3, 5)
        d = 1.0 + 0.5 * rng.random(shape)
        mv = lambda v: jnp.asarray(d) * v
        b = jnp.asarray(rng.standard_normal(shape))
        x, _ = bicgstab_mixed(mv, b, atol=1e-12, maxiter=100)
        assert x.shape == shape
        np.testing.assert_allclose(np.asarray(x), np.asarray(b) / d,
                                   atol=1e-10)

    def test_reaches_atol_at_scale_f32(self, rng):
        # A 2^21-point f32 system needing ~100+ Krylov iterations: the
        # f64 recurrence scalars must keep the iteration healthy (no
        # rho/omega collapse) all the way to the requested atol.  (The
        # vector-dtype failure this scheme exists for was observed on
        # device reductions at 25M points; XLA's CPU reductions are
        # pairwise and too accurate to reproduce it in CI, so this
        # asserts the mixed solver's own contract rather than a
        # side-by-side.)
        n = 1 << 21
        d = np.logspace(0, 3, n).astype(np.float32)
        rng.shuffle(d)
        u = (rng.standard_normal(n).astype(np.float32)) / np.sqrt(n)

        def mv(v):
            dd = jnp.asarray(d, v.dtype)
            uu = jnp.asarray(u, v.dtype)
            return dd * v + 50.0 * uu * jnp.sum(uu * v)

        b = jnp.asarray(rng.standard_normal(n), jnp.float32)
        atol = 1e-5 * float(jnp.linalg.norm(b))
        x, it = bicgstab_mixed(mv, b, atol=atol, maxiter=400)

        def mv64(v):
            return d.astype(np.float64) * v + 50.0 * u.astype(
                np.float64) * (u.astype(np.float64) @ v)

        r_mixed = float(np.linalg.norm(
            np.asarray(b, np.float64) - mv64(np.asarray(x, np.float64))))
        # The f32 iterate's true residual can't land exactly on atol
        # (the recursive residual drifts ~eps*||b||); 4x proves the
        # scalars didn't collapse over the long iteration.
        assert int(it) > 50
        assert r_mixed < 4 * atol

    def test_breakdown_freezes_not_poisons(self):
        # A singular system breaks the recurrence; the solver must stop
        # with a finite iterate (the pre-breakdown state), never NaN —
        # Newton's safeguard then falls back to a plain T(x) step.
        n = 16
        A = np.zeros((n, n)); A[0, 0] = 1.0           # rank deficient
        b = jnp.asarray(np.ones(n))
        x, _ = bicgstab_mixed(lambda v: jnp.asarray(A) @ v, b,
                              atol=1e-12, maxiter=50)
        assert bool(jnp.all(jnp.isfinite(x)))

    def test_requires_explicit_maxiter(self):
        with pytest.raises(ValueError, match="maxiter"):
            bicgstab_mixed(lambda v: v, jnp.ones(4), atol=0.0, maxiter=None)


def test_newton_uses_mixed_inner(rng):
    # End-to-end: Newton with the default inner="bicgstab" (now the
    # mixed-precision implementation) still solves a contraction.
    from sdfs_via_autodiff_tpu.solvers.fixed_point import newton_solver
    n = 32
    M = 0.5 * rng.standard_normal((n, n)) / np.sqrt(n)
    c = rng.standard_normal(n)
    T = lambda x: jnp.tanh(jnp.asarray(M) @ x) + jnp.asarray(c)
    res = newton_solver(T, jnp.zeros(n), tol=1e-12, max_iter=50)
    assert bool(res.converged)
    assert float(jnp.max(jnp.abs(T(res.x) - res.x))) < 1e-11
