"""Multi-device sharding correctness on a virtual 8-device CPU mesh.

The standard way to validate mesh layouts without several cards (SURVEY.md
§4): compare n-device sharded solves against single-device solves to tight
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdfs_via_autodiff_tpu import (
    SSY, GCY, T_gcy_factory, T_ssy_factory, discretize_gcy, discretize_ssy,
    solve)
from sdfs_via_autodiff_tpu.operators.continuous_ssy import (
    T_ssy_continuous_factory)
from sdfs_via_autodiff_tpu.ops.grids import build_grid_ssy
from sdfs_via_autodiff_tpu.parallel.mesh import (
    grid_sharding, make_mesh, shard_grid_array)

needs_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices")


@needs_devices
def test_mesh_construction():
    mesh = make_mesh(8)
    assert mesh.shape == {"dp": 4, "tp": 2}
    mesh2 = make_mesh(8, shape=(2, 4))
    assert mesh2.shape == {"dp": 2, "tp": 4}
    with pytest.raises(ValueError):
        make_mesh(8, shape=(3, 2))


@needs_devices
@pytest.mark.fast
def test_sharded_operator_matches_single_device(rng):
    model = SSY()
    shapes = (8, 8, 6, 6)
    disc = discretize_ssy(model, shapes)
    T = T_ssy_factory(model, disc, space="log")
    ell = jnp.asarray(np.log(800) + 0.05 * rng.standard_normal(shapes))

    ref = T(ell)

    mesh = make_mesh(8)          # dp=4 on axis 0, tp=2 on axis 1
    ell_sharded = shard_grid_array(ell, mesh)
    out = T(ell_sharded)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-13)


@needs_devices
def test_sharded_solve_matches_single_device():
    model = SSY()
    shapes = (8, 8, 4, 4)
    disc = discretize_ssy(model, shapes)
    T = T_ssy_factory(model, disc, space="log")
    ell0 = jnp.full(shapes, jnp.log(800.0))

    res_single = solve(T, ell0, method="newton", tol=1e-10)

    mesh = make_mesh(8)
    ell0_sharded = shard_grid_array(ell0, mesh)
    res_sharded = solve(T, ell0_sharded, method="newton", tol=1e-10)

    assert bool(res_sharded.converged)
    np.testing.assert_allclose(np.asarray(res_sharded.x),
                               np.asarray(res_single.x), atol=1e-12)
    # The sharded solve's iterate keeps its sharding (no silent gather).
    assert not res_sharded.x.sharding.is_fully_replicated


@needs_devices
def test_sharded_continuous_factored(rng):
    model = SSY()
    grids = build_grid_ssy(model, 8, 8, 6, 6)
    T = T_ssy_continuous_factory(model, grids, interp="pre", space="log")
    shapes = (8, 8, 6, 6)
    ell = jnp.asarray(np.log(700) + 0.02 * rng.standard_normal(shapes))
    ref = T(ell)
    mesh = make_mesh(8)
    out = T(shard_grid_array(ell, mesh))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-13)


@needs_devices
def test_sharded_gcy(rng):
    model = GCY()
    shapes = (4, 4, 4, 4, 2, 2)
    disc = discretize_gcy(model, shapes)
    T = T_gcy_factory(model, disc, space="log")
    ell = jnp.asarray(np.log(500) + 0.02 * rng.standard_normal(shapes))
    ref = T(ell)
    mesh = make_mesh(8, shape=(4, 2))
    out = T(shard_grid_array(ell, mesh))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-13)


@needs_devices
def test_sharded_gcy_continuous_factored(rng):
    # GCY continuous (factored quadrature, conditional expectation
    # matrices) under GSPMD sharding — the last operator family without
    # a sharded-vs-single-device pin.
    from sdfs_via_autodiff_tpu import build_grid_gcy
    from sdfs_via_autodiff_tpu.operators.continuous_gcy import (
        T_gcy_continuous_factory)
    model = GCY()
    shapes = (4, 4, 4, 4, 2, 2)
    grids = build_grid_gcy(model, *shapes)
    T = T_gcy_continuous_factory(model, grids, method="quadrature",
                                 interp="pre", space="log", quad_degree=3)
    ell = jnp.asarray(np.log(500) + 0.02 * rng.standard_normal(shapes))
    ref = T(ell)
    mesh = make_mesh(8, shape=(4, 2))
    out = T(shard_grid_array(ell, mesh))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-13)


@needs_devices
def test_anderson_on_sharded_iterate():
    # Anderson histories live on device; the solve must work when the
    # iterate (and hence the flattened history rows) is sharded.
    model = SSY()
    shapes = (8, 8, 4, 4)
    disc = discretize_ssy(model, shapes)
    T = T_ssy_factory(model, disc, space="log")
    ell0 = jnp.full(shapes, jnp.log(800.0))
    mesh = make_mesh(8)
    res = solve(T, shard_grid_array(ell0, mesh), method="anderson", tol=1e-9)
    assert bool(res.converged)
    res_single = solve(T, ell0, method="anderson", tol=1e-9)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(res_single.x),
                               atol=1e-10)


@needs_devices
def test_shard_map_explicit_matches_gspmd(rng):
    # Hand-placed collectives (pmax + psum_scatter) against the GSPMD
    # auto-partitioned operator, bit-for-bit-ish.
    from jax.sharding import PartitionSpec, NamedSharding
    from sdfs_via_autodiff_tpu.parallel.shard_ops import (
        T_ssy_shard_map_factory)
    model = SSY()
    shapes = (8, 6, 6, 6)
    disc = discretize_ssy(model, shapes)
    T_auto = T_ssy_factory(model, disc, space="log")

    mesh = make_mesh(8, shape=(8, 1))
    T_manual = T_ssy_shard_map_factory(model, disc, mesh)
    ell = jnp.asarray(np.log(800) + 0.05 * rng.standard_normal(shapes))
    ref = np.asarray(T_auto(ell))
    ell_sharded = jax.device_put(ell, T_manual.input_sharding)
    out = T_manual(ell_sharded)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-12)
    # Output keeps the sharding.
    assert not out.sharding.is_fully_replicated


@needs_devices
class TestTwoPhaseShardMap:
    """2-D (dp, tp) hand-placed collectives over the two-phase operators:
    both row contractions cross a mesh axis (pmax + psum_scatter each)."""

    def _mesh(self):
        return make_mesh(8)          # dp=4, tp=2

    def test_discrete_plain_matches_gspmd(self, rng):
        from sdfs_via_autodiff_tpu.operators.two_phase import (
            two_phase_operands_ssy)
        from sdfs_via_autodiff_tpu.parallel.shard_ops import (
            two_phase_shard_map_factory)
        model = SSY()
        shapes = (8, 8, 6, 6)
        disc = discretize_ssy(model, shapes)
        ops = two_phase_operands_ssy(model, disc)
        mesh = self._mesh()
        T_manual = two_phase_shard_map_factory(ops, mesh, dtype=jnp.float64)
        T_auto = T_ssy_factory(model, disc, space="log")
        ell = jnp.asarray(np.log(800) + 0.05 * rng.standard_normal(shapes))
        out = T_manual(jax.device_put(ell, T_manual.input_sharding))
        np.testing.assert_allclose(np.asarray(out), np.asarray(T_auto(ell)),
                                   atol=1e-12)
        assert not out.sharding.is_fully_replicated

    def test_discrete_normalized_matches(self, rng):
        from sdfs_via_autodiff_tpu.operators.two_phase import (
            two_phase_operands_ssy)
        from sdfs_via_autodiff_tpu.parallel.shard_ops import (
            two_phase_shard_map_factory)
        model = SSY()
        shapes = (8, 8, 6, 6)
        disc = discretize_ssy(model, shapes)
        ops = two_phase_operands_ssy(model, disc, baseline="loglinear")
        T_manual = two_phase_shard_map_factory(ops, self._mesh(),
                                               dtype=jnp.float64)
        T_ref = T_ssy_factory(model, disc, space="log", baseline="loglinear",
                              dtype=jnp.float64)
        ell = jnp.asarray(np.log(800) + 0.05 * rng.standard_normal(shapes))
        out = T_manual(jax.device_put(ell, T_manual.input_sharding))
        np.testing.assert_allclose(np.asarray(out), np.asarray(T_ref(ell)),
                                   rtol=1e-11, atol=1e-11)

    def test_continuous_matches(self, rng):
        from sdfs_via_autodiff_tpu.operators.two_phase import (
            two_phase_operands_ssy_continuous)
        from sdfs_via_autodiff_tpu.parallel.shard_ops import (
            two_phase_shard_map_factory)
        model = SSY()
        grids = build_grid_ssy(model, 8, 8, 6, 6)
        ops = two_phase_operands_ssy_continuous(model, grids, degree=5)
        T_manual = two_phase_shard_map_factory(ops, self._mesh(),
                                               dtype=jnp.float64)
        T_ref = T_ssy_continuous_factory(model, grids, interp="pre",
                                         space="log")
        ell = jnp.asarray(np.log(700) + 0.02 * rng.standard_normal((8, 8, 6, 6)))
        out = T_manual(jax.device_put(ell, T_manual.input_sharding))
        np.testing.assert_allclose(np.asarray(out), np.asarray(T_ref(ell)),
                                   atol=1e-12)

    def test_newton_solve_through_manual_collectives(self):
        from sdfs_via_autodiff_tpu.operators.two_phase import (
            two_phase_operands_ssy)
        from sdfs_via_autodiff_tpu.parallel.shard_ops import (
            two_phase_shard_map_factory)
        model = SSY()
        shapes = (8, 8, 4, 4)
        disc = discretize_ssy(model, shapes)
        ops = two_phase_operands_ssy(model, disc)
        T_manual = two_phase_shard_map_factory(ops, self._mesh(),
                                               dtype=jnp.float64)
        ell0 = jax.device_put(jnp.full(shapes, jnp.log(800.0)),
                              T_manual.input_sharding)
        res = solve(T_manual, ell0, method="newton", tol=1e-10)
        assert bool(res.converged)
        T_ref = T_ssy_factory(model, disc, space="log")
        ref = solve(T_ref, jnp.full(shapes, jnp.log(800.0)), method="newton",
                    tol=1e-10)
        np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                                   atol=1e-9)

    def test_manual_collective_counts(self, rng):
        # The hand-placed program should contain exactly the planned
        # collectives: one reduce-scatter per sharded row contraction.
        from sdfs_via_autodiff_tpu.operators.two_phase import (
            two_phase_operands_ssy)
        from sdfs_via_autodiff_tpu.parallel.shard_ops import (
            two_phase_shard_map_factory)
        model = SSY()
        shapes = (8, 8, 6, 6)
        disc = discretize_ssy(model, shapes)
        ops = two_phase_operands_ssy(model, disc)
        mesh = self._mesh()
        T_manual = two_phase_shard_map_factory(ops, mesh, dtype=jnp.float64)
        ell = jax.device_put(jnp.full(shapes, jnp.log(800.0)),
                             T_manual.input_sharding)
        txt = jax.jit(T_manual).lower(ell).compile().as_text()
        n_rs = txt.count("reduce-scatter")
        n_ag = txt.count("all-gather(") + txt.count("all-gather-start")
        assert n_rs >= 2, f"expected >=2 reduce-scatters, HLO has {n_rs}"
        # No full-iterate gather sneaks in.
        assert n_ag == 0, f"unexpected all-gather in manual program ({n_ag})"


@needs_devices
def test_shard_map_solve(rng):
    from sdfs_via_autodiff_tpu.parallel.shard_ops import (
        T_ssy_shard_map_factory)
    model = SSY()
    shapes = (8, 6, 4, 4)
    disc = discretize_ssy(model, shapes)
    mesh = make_mesh(8, shape=(8, 1))
    T_manual = T_ssy_shard_map_factory(model, disc, mesh)
    ell0 = jax.device_put(jnp.full(shapes, jnp.log(800.0)),
                          T_manual.input_sharding)
    res = solve(T_manual, ell0, method="newton", tol=1e-10)
    assert bool(res.converged)
    T_ref = T_ssy_factory(model, disc, space="log")
    ref = solve(T_ref, jnp.full(shapes, jnp.log(800.0)), method="newton",
                tol=1e-10)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               atol=1e-10)


@needs_devices
def test_gcy_kron_two_phase_shard_map_matches_single_device(rng):
    # The explicit (dp, tp) shard_map program covers ANY TwoPhaseOperands
    # instance — including the six-state GCY Kronecker grouping, whose
    # row group (h_c, h_lam) shards over the mesh while the big
    # (z x z_pi) / (h_z x h_zpi) column contractions stay shard-local.
    from sdfs_via_autodiff_tpu.operators.two_phase import (
        make_xla_two_phase_T, two_phase_operands_gcy)
    from sdfs_via_autodiff_tpu.parallel.mesh import make_mesh
    from sdfs_via_autodiff_tpu.parallel.shard_ops import (
        two_phase_shard_map_factory)

    model = GCY()
    shapes = (3, 4, 3, 4, 3, 4)      # rows (h_c=4, h_lam=4) / mesh (4, 2)
    disc = discretize_gcy(model, shapes)
    ops = two_phase_operands_gcy(model, disc)
    mesh = make_mesh(8)
    T_sharded = two_phase_shard_map_factory(ops, mesh, dtype=jnp.float64)
    T_single = make_xla_two_phase_T(ops, jnp.float64)
    ell = jnp.asarray(np.log(300.0) + 0.1 * rng.standard_normal(ops.shapes))
    ell_sharded = jax.device_put(ell, T_sharded.input_sharding)
    np.testing.assert_allclose(np.asarray(T_sharded(ell_sharded)),
                               np.asarray(T_single(ell)), atol=1e-12,
                               rtol=0)
    # Newton through the hand-placed collectives.
    res = solve(T_sharded, ell_sharded, method="newton", tol=1e-10,
                max_iter=30)
    assert bool(res.converged)
    res_single = solve(T_single, ell, method="newton", tol=1e-10,
                       max_iter=30)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(res_single.x),
                               atol=1e-9, rtol=0)


def _max_allgather_elems(hlo_txt: str) -> int:
    """Largest element count produced by any all-gather in compiled HLO
    (0 if none).  Small gathers (Anderson Gram rows, per-row scale
    vectors) are legitimate; an iterate-sized one means GSPMD or the
    program de-sharded the field."""
    import re

    worst = 0
    for line in hlo_txt.splitlines():
        if "all-gather" not in line:
            continue
        m = re.search(r"[a-z0-9]+\[([0-9,]*)\]", line)
        if m:
            dims = [int(d) for d in m.group(1).split(",") if d]
            n = int(np.prod(dims)) if dims else 1
            worst = max(worst, n)
    return worst


@needs_devices
class TestShardingPreservedInHLO:
    """Round-2 review item #7: compile the sharded solver loops and
    assert no all-gather of the iterate appears — a failing test if a
    future change de-shards the iterate."""

    SHAPES = (8, 8, 6, 6)

    def _lowered_text(self, T, x0, method, **kw):
        def run(x):
            return solve(T, x, method=method, jit=False, **kw).x
        return jax.jit(run).lower(x0).compile().as_text()

    def test_newton_loop_keeps_iterate_sharded(self):
        from sdfs_via_autodiff_tpu.operators.two_phase import (
            two_phase_operands_ssy)
        from sdfs_via_autodiff_tpu.parallel.shard_ops import (
            two_phase_shard_map_factory)
        model = SSY()
        disc = discretize_ssy(model, self.SHAPES)
        ops = two_phase_operands_ssy(model, disc)
        mesh = make_mesh(8)
        T = two_phase_shard_map_factory(ops, mesh, dtype=jnp.float64)
        x0 = jax.device_put(jnp.full(self.SHAPES, jnp.log(800.0)),
                            T.input_sharding)
        txt = self._lowered_text(T, x0, "newton", tol=1e-10, max_iter=5)
        # Sanity: the program really is partitioned (collectives exist),
        # so the no-gather assertion below is meaningful.
        assert any(c in txt for c in
                   ("reduce-scatter", "all-reduce", "collective-permute")), \
            "lowered program has no collectives; partitioning didn't happen"
        n = int(np.prod(self.SHAPES))
        worst = _max_allgather_elems(txt)
        assert worst < n, (
            f"compiled Newton loop all-gathers {worst} elements "
            f"(iterate is {n}): the iterate lost its sharding")

    def test_anderson_loop_keeps_iterate_sharded(self):
        model = SSY()
        disc = discretize_ssy(model, self.SHAPES)
        T = T_ssy_factory(model, disc, space="log")
        mesh = make_mesh(8)
        x0 = shard_grid_array(jnp.full(self.SHAPES, jnp.log(800.0)), mesh)
        txt = self._lowered_text(T, x0, "anderson", tol=1e-9, max_iter=30)
        n = int(np.prod(self.SHAPES))
        worst = _max_allgather_elems(txt)
        # Anderson gathers only Gram-matrix rows / coefficient vectors
        # (history_size-scale, << the iterate).
        assert worst < n, (
            f"compiled Anderson loop all-gathers {worst} elements "
            f"(iterate is {n}): the iterate lost its sharding")

    def test_sa_loop_keeps_iterate_sharded(self):
        model = SSY()
        disc = discretize_ssy(model, self.SHAPES)
        T = T_ssy_factory(model, disc, space="log")
        mesh = make_mesh(8)
        x0 = shard_grid_array(jnp.full(self.SHAPES, jnp.log(800.0)), mesh)
        txt = self._lowered_text(T, x0, "successive_approx", tol=1e-9,
                                 max_iter=50)
        worst = _max_allgather_elems(txt)
        n = int(np.prod(self.SHAPES))
        assert worst < n, (
            f"compiled SA loop all-gathers {worst} elements "
            f"(iterate is {n})")


@needs_devices
def test_implicit_gradient_on_sharded_iterate():
    """Calibration gradients ride the GSPMD tier: implicit_fixed_point
    started from a mesh-sharded iterate (the solver loop keeps it sharded,
    and the adjoint Krylov solve's VJP matvecs inherit the layout) returns
    the same gradient as the single-device run."""
    import dataclasses as dc

    from sdfs_via_autodiff_tpu.operators.continuous_ssy import _factored_T
    from sdfs_via_autodiff_tpu.solvers import implicit_fixed_point

    model = SSY()
    sizes = (8, 8, 6, 6)
    grids = build_grid_ssy(model, *sizes)

    def T_of_p(p, x):
        return _factored_T(dc.replace(model, beta=p["beta"]), grids, 3,
                           "log", jnp.float64, None)(x)

    p0 = {"beta": jnp.asarray(model.beta)}

    def grad_for(x0):
        loss = lambda p: jnp.mean(implicit_fixed_point(
            T_of_p, p, x0, method="newton", tol=1e-10))
        return jax.grad(loss)(p0)

    x0 = jnp.full(sizes, jnp.log(800.0))
    g_ref = grad_for(x0)
    mesh = make_mesh(8)
    g_sh = grad_for(shard_grid_array(x0, mesh))
    np.testing.assert_allclose(float(g_sh["beta"]), float(g_ref["beta"]),
                               rtol=1e-8)


@needs_devices
def test_degroot_sharded_solve_matches_single_device():
    # The de Groot chain is the standard per-axis contraction structure
    # minus the lambda tilt, so the GSPMD mesh path covers it with no
    # operator changes: sharded Newton solve bit-matches single-device.
    from sdfs_via_autodiff_tpu.operators.degroot import T_degroot_factory

    model = SSY()
    disc = discretize_ssy(model, (8, 4, 4, 4))
    T = T_degroot_factory(model, disc, space="log", h=0.99)
    ell0 = jnp.full((8, 4, 4, 4),
                    model.theta * float(np.log((1 - model.beta) * 800.0)))
    res_single = solve(T, ell0, method="newton", tol=1e-11)
    assert bool(res_single.converged)

    mesh = make_mesh(8)
    res_sharded = solve(T, shard_grid_array(ell0, mesh), method="newton",
                        tol=1e-11)
    assert bool(res_sharded.converged)
    np.testing.assert_allclose(np.asarray(res_sharded.x),
                               np.asarray(res_single.x), atol=1e-12)
