"""Explicit shard_map operators with hand-placed collectives.

The default multi-device path lets GSPMD partition the einsum chains
(``parallel/mesh.py``).  This module is the explicit counterpart for the
discrete SSY log-space operator: w is sharded over its leading (h_lam)
grid axis, and the one contraction that crosses shards — over next-h_lam —
is written as

    local partial matmul  ->  psum_scatter over the mesh axis

i.e. a reduce-scatter between the devices, with the per-axis log-sum-exp
shift's max computed by ``lax.pmax``.  The remaining three contractions are
shard-local.  This is the communication shape SURVEY.md §5 describes for
sharded-axis contractions; XLA hands psum_scatter to NCCL on the GPU.

Used for: pinning down the collective pattern (tested against the GSPMD
path on virtual meshes, and on four cards by ``chip_smoke.py --devices 4``).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from jax import shard_map

from ..models.ssy import SSY
from ..operators.discrete_ssy import SSYDiscretization, _ssy_factors

__all__ = ["T_ssy_shard_map_factory", "two_phase_shard_map_factory"]


def two_phase_shard_map_factory(ops, mesh: Mesh,
                                dp_axis: str = "dp",
                                tp_axis: str = "tp",
                                dtype=None) -> Callable:
    """Two-phase operator (``operators/two_phase.py``) as an explicit
    shard_map program over a 2-D (dp, tp) mesh.

    The iterate ell[r1, r2, c1, c2] is sharded (dp, tp, -, -).  The two
    column contractions are shard-local; each row contraction crosses a
    mesh axis and is written as

        pmax (LSE shift)  ->  local partial matmul against the factor's
        column block      ->  psum_scatter over that mesh axis

    — two reduce-scatters per application, one per sharded grid axis.  Covers every TwoPhaseOperands instance (discrete SSY
    plain/normalized, continuous factored-quadrature SSY), so the same
    hand-placed collective pattern runs the continuous production path.
    Differentiable (the pmax shifts ride stop_gradient; psum_scatter has
    a transpose rule), so Newton-through-shard_map works.
    """
    n_r1, n_r2, n_c1, n_c2 = ops.shapes
    n_dp, n_tp = mesh.shape[dp_axis], mesh.shape[tp_axis]
    if n_r1 % n_dp or n_r2 % n_tp:
        raise ValueError(
            f"row axes {(n_r1, n_r2)} not divisible by mesh {(n_dp, n_tp)}")

    if getattr(ops, "pair_c2", None) is not None:
        # Pair sets carry a W_c2 placeholder (the real factors live in
        # pair_c2); contracting the placeholder here would be silent
        # garbage.  Multi-device continuous GCY runs the GSPMD per-axis
        # chain (parallel/mesh.py).
        raise ValueError(
            "two_phase_shard_map_factory does not evaluate pair-"
            "factored operand sets; use the GSPMD per-axis chain")
    work = dtype or jnp.float32
    cast = lambda a: jnp.asarray(a, work)
    W_r1, W_r2, W_c1, W_c2 = map(cast, (ops.W_r1, ops.W_r2, ops.W_c1,
                                        ops.W_c2))
    add = cast(ops.add_row[:, :, None, None]
               + ops.add_col[None, None, :, :])
    sub = cast(ops.sub_row[:, :, None, None]
               + ops.sub_col[None, None, :, :]) if ops.has_sub else None
    theta = float(ops.theta)
    beta = float(ops.beta)
    c1_sub = "jim,lkmj->lkij" if ops.c1_batched else "im,lkmj->lkij"
    c2_sub = "ijm,lkim->lkij" if ops.c2_batched else "jm,lkim->lkij"
    hi = jax.lax.Precision.HIGHEST

    spec = PartitionSpec(dp_axis, tp_axis, None, None)
    rep2 = PartitionSpec(None, None)
    rep3 = PartitionSpec(None, None, None)

    def cross_shard_lse(a, W_cols, axis, mesh_axis):
        """LSE-contract sharded grid ``axis`` (0 or 1): pmax shift, local
        partial matmul against the factor's column block, reduce-scatter."""
        m = lax.pmax(jnp.max(lax.stop_gradient(a), axis=axis, keepdims=True),
                     mesh_axis)
        e = jnp.exp(a - m)
        subs = "lm,mkij->lkij" if axis == 0 else "km,lmij->lkij"
        partial_u = jnp.einsum(subs, W_cols, e, precision=hi)
        u = lax.psum_scatter(partial_u, mesh_axis, scatter_dimension=axis,
                             tiled=True)
        return m + jnp.log(u)

    def local_T(ell_loc, Wr1_cols, Wr2_cols, Wc1_, Wc2_, add_loc,
                *maybe_sub):
        a = theta * ell_loc
        if maybe_sub:
            a = a - maybe_sub[0]
        # Column phase: shard-local.
        m = jnp.max(a, axis=2, keepdims=True)
        a = m + jnp.log(jnp.einsum(c1_sub, Wc1_, jnp.exp(a - m),
                                   precision=hi))
        m = jnp.max(a, axis=3, keepdims=True)
        a = m + jnp.log(jnp.einsum(c2_sub, Wc2_, jnp.exp(a - m),
                                   precision=hi))
        # Row phase: one reduce-scatter per sharded axis.
        a = cross_shard_lse(a, Wr1_cols, 0, dp_axis)
        a = cross_shard_lse(a, Wr2_cols, 1, tp_axis)
        log_hwt = a + add_loc
        return jnp.log1p(beta * jnp.exp(log_hwt / theta))

    wc1_spec = rep3 if ops.c1_batched else rep2
    wc2_spec = rep3 if ops.c2_batched else rep2
    in_specs = (spec, PartitionSpec(None, dp_axis),
                PartitionSpec(None, tp_axis), wc1_spec, wc2_spec, spec)
    args = (W_r1, W_r2, W_c1, W_c2, add)
    if sub is not None:
        in_specs = in_specs + (spec,)
        args = args + (sub,)
    mapped = shard_map(local_T, mesh=mesh, in_specs=in_specs,
                       out_specs=spec)

    @jax.jit
    def T(ell):
        return mapped(ell.astype(work), *args)

    T.input_sharding = NamedSharding(mesh, spec)
    if ops.baseline_log_w is not None:
        T.baseline_log_w = cast(ops.baseline_log_w)
    return T


def T_ssy_shard_map_factory(model: SSY,
                            disc: SSYDiscretization,
                            mesh: Mesh,
                            axis_name: str = "dp",
                            dtype=None) -> Callable:
    """Log-space discrete SSY operator as an explicit shard_map program.

    The iterate is sharded over grid axis 0 (h_lam) on ``axis_name``;
    returns a jitted T preserving that sharding.  Requires
    n_h_lam % mesh.shape[axis_name] == 0.
    """
    beta, theta = model.beta, model.theta
    n_l = disc.shapes[0]
    n_dev = mesh.shape[axis_name]
    if n_l % n_dev:
        raise ValueError(f"h_lam axis {n_l} not divisible by mesh axis "
                         f"{axis_name}={n_dev}")

    B_lam, A2, A3 = _ssy_factors(model, disc)
    log_A2, log_A3 = jnp.log(A2), jnp.log(A3)
    Qc, Qhz, zP = disc.h_c_Q, disc.h_z_Q, disc.z_P
    if dtype is not None:
        (B_lam, log_A2, log_A3, Qc, Qhz, zP) = (
            a.astype(dtype) for a in (B_lam, log_A2, log_A3, Qc, Qhz, zP))

    spec = PartitionSpec(axis_name, None, None, None)
    # B_lam's columns (next-h_lam) are sharded to match the local rows of
    # the iterate; its rows (current-h_lam) stay full for the partial
    # matmul, and psum_scatter distributes the summed rows back out.
    colspec = PartitionSpec(None, axis_name)

    def local_T(ell_local, B_cols, lA2, lA3, Qc_, Qhz_, zP_):
        p = theta * ell_local
        # LSE shift for the cross-shard contraction: global max over the
        # sharded next-h_lam axis per (k, i, j) column.  The shift cancels
        # exactly in the result, so it carries no tangent — computed on a
        # stop_gradient'd value (also required because pmax has no
        # differentiation rule).
        m_local = jnp.max(lax.stop_gradient(p), axis=0, keepdims=True)
        m = lax.pmax(m_local, axis_name)
        v = jnp.exp(p - m)
        partial_u = jnp.einsum("lm,mkij->lkij", B_cols, v,
                               precision=lax.Precision.HIGHEST)
        u = lax.psum_scatter(partial_u, axis_name, scatter_dimension=0,
                             tiled=True)
        a = m + jnp.log(u)
        # Remaining contractions are shard-local (k, i, j unsharded).
        from ..ops.contract import lse_matmul
        a = lse_matmul(Qc_, a, "km,lmij->lkij", 1)
        a = lse_matmul(Qhz_, a, "im,lkmj->lkij", 2)
        a = lse_matmul(zP_, a, "jm,lkim->lkij", 3)
        log_hwt = (a + lA2[None, :, None, None] + lA3[None, None, :, :])
        return jnp.log1p(beta * jnp.exp(log_hwt / theta))

    mapped = shard_map(
        local_T, mesh=mesh,
        in_specs=(spec, colspec, PartitionSpec(None), PartitionSpec(None, None),
                  PartitionSpec(None, None), PartitionSpec(None, None),
                  PartitionSpec(None, None)),
        out_specs=spec)

    @jax.jit
    def T(ell):
        return mapped(ell, B_lam, log_A2, log_A3, Qc, Qhz, zP)

    T.input_sharding = NamedSharding(mesh, spec)
    return T
