"""Node-chain post/loglin-interpolation operator: exactness vs the gather
oracle, MC parity, autodiff."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdfs_via_autodiff_tpu import SSY, build_grid_ssy
from sdfs_via_autodiff_tpu.operators.continuous_common import make_gather_T
from sdfs_via_autodiff_tpu.operators.continuous_ssy import (
    T_ssy_continuous_factory, _log_kappa_ssy, next_state_ssy)
from sdfs_via_autodiff_tpu.operators.post_interp import (
    make_node_chain_T_ssy, ssy_quadrature_nodes)
from sdfs_via_autodiff_tpu.ops.quadrature import tensor_quadrature_normal

SIZES = (4, 5, 6, 7)


@pytest.fixture(scope="module")
def setup():
    model = SSY()
    grids = build_grid_ssy(model, *SIZES)
    return model, grids


def rand_ell(rng, spread=0.1):
    return jnp.asarray(np.log(700.0) + spread * rng.standard_normal(SIZES))


def _gather_T(model, grids, shocks, weights, interp):
    return make_gather_T(lambda x, s: next_state_ssy(model, x, s),
                         lambda x: _log_kappa_ssy(model, x[1], x[3]),
                         grids, jnp.asarray(shocks),
                         None if weights is None else jnp.asarray(weights),
                         interp, "log", None, model.beta, model.theta)


@pytest.mark.parametrize("interp", ["post", "loglin"])
def test_node_chain_equals_gather_quadrature(setup, rng, interp):
    # The node-chain reformulation is EXACT: same corner weights as the
    # pointwise gather, reordered into per-axis matmuls.
    model, grids = setup
    nodes, weights = tensor_quadrature_normal([4] * 4)
    T_nc = make_node_chain_T_ssy(model, grids, nodes, np.log(weights),
                                 interp=interp)
    T_g = _gather_T(model, grids, nodes, weights, interp)
    ell = rand_ell(rng)
    np.testing.assert_allclose(np.asarray(T_nc(ell)), np.asarray(T_g(ell)),
                               atol=1e-11, rtol=0)


def test_node_chain_equals_gather_mc(setup, rng):
    # Joint Monte Carlo draws are nodes too: no tensor-product structure
    # required.
    model, grids = setup
    draws = rng.standard_normal((4, 100))
    logw = np.full(100, -np.log(100.0))
    T_nc = make_node_chain_T_ssy(model, grids, draws, logw, interp="post",
                                 chunk=16)
    T_g = _gather_T(model, grids, draws, None, "post")
    ell = rand_ell(rng)
    np.testing.assert_allclose(np.asarray(T_nc(ell)), np.asarray(T_g(ell)),
                               atol=1e-11, rtol=0)


def test_node_chain_chunk_padding(setup, rng):
    # Q=256 with chunk=48 pads to 288; padded nodes carry -inf weight.
    model, grids = setup
    nodes, logw = ssy_quadrature_nodes(4)
    T_a = make_node_chain_T_ssy(model, grids, nodes, logw, chunk=48)
    T_b = make_node_chain_T_ssy(model, grids, nodes, logw, chunk=256)
    ell = rand_ell(rng)
    np.testing.assert_allclose(np.asarray(T_a(ell)), np.asarray(T_b(ell)),
                               atol=1e-12, rtol=0)


def test_node_chain_jvp_matches_fd(setup, rng):
    model, grids = setup
    nodes, logw = ssy_quadrature_nodes(3)
    T = make_node_chain_T_ssy(model, grids, nodes, logw, interp="post",
                              chunk=9)
    ell = rand_ell(rng)
    vec = jnp.asarray(rng.standard_normal(SIZES))
    _, dout = jax.jvp(T, (ell,), (vec,))
    assert bool(jnp.all(jnp.isfinite(dout)))
    eps = 1e-6
    fd = (T(ell + eps * vec) - T(ell - eps * vec)) / (2 * eps)
    np.testing.assert_allclose(np.asarray(dout), np.asarray(fd), atol=1e-7,
                               rtol=0)


def test_factory_dispatches_node_chain(setup, rng):
    # post/loglin + log space now route through the node chain by default;
    # engine="gather" preserves the pointwise path, and both agree.
    model, grids = setup
    ell = rand_ell(rng)
    for interp in ("post", "loglin"):
        T_auto = T_ssy_continuous_factory(model, grids, interp=interp,
                                          space="log", quad_degree=4)
        T_gather = T_ssy_continuous_factory(model, grids, interp=interp,
                                            space="log", quad_degree=4,
                                            engine="gather")
        np.testing.assert_allclose(np.asarray(T_auto(ell)),
                                   np.asarray(T_gather(ell)), atol=1e-8,
                                   rtol=0)


def test_factory_mc_node_chain_matches_gather(setup, rng):
    model, grids = setup
    ell = rand_ell(rng)
    kw = dict(method="monte_carlo", interp="post", space="log",
              mc_draw_size=64, seed=7)
    T_auto = T_ssy_continuous_factory(model, grids, **kw)
    T_gather = T_ssy_continuous_factory(model, grids, engine="gather", **kw)
    np.testing.assert_allclose(np.asarray(T_auto(ell)),
                               np.asarray(T_gather(ell)), atol=1e-8, rtol=0)


class TestGCYNodeChain:
    SIZES = (3, 4, 3, 3, 4, 3)

    @pytest.fixture(scope="class")
    def gcy_setup(self):
        from sdfs_via_autodiff_tpu import GCY
        from sdfs_via_autodiff_tpu.ops.grids import build_grid_gcy
        model = GCY()
        return model, build_grid_gcy(model, *self.SIZES)

    def _gather(self, model, grids, shocks, weights, interp):
        from sdfs_via_autodiff_tpu.operators.continuous_gcy import (
            _log_kappa_gcy, next_state_gcy)
        return make_gather_T(
            lambda x, s: next_state_gcy(model, x, s),
            lambda x: _log_kappa_gcy(model, x[1], x[4]),
            grids, jnp.asarray(shocks),
            None if weights is None else jnp.asarray(weights),
            interp, "log", None, model.beta, model.theta)

    @pytest.mark.parametrize("interp", ["post", "loglin"])
    def test_quadrature_matches_gather(self, gcy_setup, rng, interp):
        from sdfs_via_autodiff_tpu.operators.post_interp import (
            make_node_chain_T_gcy)
        model, grids = gcy_setup
        nodes, weights = tensor_quadrature_normal([3] * 6)
        T_nc = make_node_chain_T_gcy(model, grids, nodes, np.log(weights),
                                     interp=interp, chunk=81)
        T_g = self._gather(model, grids, nodes, weights, interp)
        ell = jnp.asarray(np.log(300.0)
                          + 0.1 * rng.standard_normal(self.SIZES))
        np.testing.assert_allclose(np.asarray(T_nc(ell)),
                                   np.asarray(T_g(ell)), atol=1e-11, rtol=0)

    def test_mc_matches_gather_and_jvp(self, gcy_setup, rng):
        from sdfs_via_autodiff_tpu.operators.post_interp import (
            make_node_chain_T_gcy)
        model, grids = gcy_setup
        draws = rng.standard_normal((6, 60))
        logw = np.full(60, -np.log(60.0))
        T_nc = make_node_chain_T_gcy(model, grids, draws, logw,
                                     interp="post", chunk=16)
        T_g = self._gather(model, grids, draws, None, "post")
        ell = jnp.asarray(np.log(300.0)
                          + 0.1 * rng.standard_normal(self.SIZES))
        np.testing.assert_allclose(np.asarray(T_nc(ell)),
                                   np.asarray(T_g(ell)), atol=1e-11, rtol=0)
        v = jnp.asarray(rng.standard_normal(self.SIZES))
        _, d = jax.jvp(T_nc, (ell,), (v,))
        assert bool(jnp.all(jnp.isfinite(d)))

    def test_factory_dispatch(self, gcy_setup, rng):
        from sdfs_via_autodiff_tpu.operators.continuous_gcy import (
            T_gcy_continuous_factory)
        model, grids = gcy_setup
        ell = jnp.asarray(np.log(300.0)
                          + 0.1 * rng.standard_normal(self.SIZES))
        kw = dict(method="monte_carlo", interp="post", space="log",
                  mc_draw_size=40, seed=3)
        T_auto = T_gcy_continuous_factory(model, grids, **kw)
        T_gather = T_gcy_continuous_factory(model, grids, engine="gather",
                                            **kw)
        np.testing.assert_allclose(np.asarray(T_auto(ell)),
                                   np.asarray(T_gather(ell)), atol=1e-8,
                                   rtol=0)
