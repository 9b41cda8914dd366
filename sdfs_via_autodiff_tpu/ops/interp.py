"""Multilinear interpolation on uniform tensor-product grids.

Replaces the reference's ``vals_to_coords`` + ``jax.scipy.ndimage.
map_coordinates(order=1, mode='nearest')`` pair (reference
``code/utils.py:6-23``) with a self-contained corner-gather implementation:
out-of-range query points are clamped to the grid edges (the 'nearest'
boundary rule), interior points get the standard 2^d-corner convex
combination.  Written as plain JAX gathers so it vmaps, jits, shards and
differentiates.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import jax.numpy as jnp

__all__ = ["uniform_grid_coords", "multilinear_interp", "lin_interp"]


def uniform_grid_coords(grids: Sequence[jnp.ndarray], x: jnp.ndarray) -> jnp.ndarray:
    """Affine map from state values to fractional grid coordinates.

    ``x`` has shape (dim, ...); grid d contributes coordinate
    ``(x[d] - grid[0]) / (grid[1] - grid[0])``.  Assumes uniform grids
    (same assumption as reference ``code/utils.py:6-14``).
    """
    # A size-1 (collapsed) grid has no step; any finite value maps every
    # query to coordinate 0, which multilinear_interp's n == 1 handling
    # then clamps — matching map_coordinates on a degenerate axis.
    steps = jnp.stack([g[1] - g[0] if g.shape[0] > 1
                       else jnp.ones((), g.dtype) for g in grids])
    lows = jnp.stack([g[0] for g in grids])
    bshape = (len(grids),) + (1,) * (x.ndim - 1)
    return (x - lows.reshape(bshape)) / steps.reshape(bshape)


def multilinear_interp(values: jnp.ndarray, coords: jnp.ndarray) -> jnp.ndarray:
    """Interpolate ``values`` (shape ``grid_shape``) at fractional ``coords``
    (shape ``(dim, N)``); returns shape ``(N,)``.

    Edge handling clamps coordinates into the valid cell range, matching
    ``map_coordinates(order=1, mode='nearest')``.
    """
    dim = values.ndim
    if coords.shape[0] != dim:
        raise ValueError(f"coords leading axis {coords.shape[0]} != values ndim {dim}")

    lo_idx = []
    frac = []
    for d in range(dim):
        n = values.shape[d]
        c = coords[d]
        if n == 1:
            lo_idx.append(jnp.zeros_like(c, dtype=jnp.int32))
            frac.append(jnp.zeros_like(c))
            continue
        i0 = jnp.clip(jnp.floor(c), 0, n - 2).astype(jnp.int32)
        t = jnp.clip(c - i0, 0.0, 1.0)
        lo_idx.append(i0)
        frac.append(t)

    out = None
    for corner in itertools.product((0, 1), repeat=dim):
        idx = tuple(lo_idx[d] + corner[d] if values.shape[d] > 1 else lo_idx[d]
                    for d in range(dim))
        wgt = None
        for d in range(dim):
            f = frac[d] if corner[d] else 1.0 - frac[d]
            wgt = f if wgt is None else wgt * f
        term = values[idx] * wgt
        out = term if out is None else out + term
    return out


def lin_interp(x: jnp.ndarray, fun_vals: jnp.ndarray,
               grids: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """Drop-in equivalent of reference ``lin_interp(x, fun_vals, grids)``
    (``code/utils.py:17-23``): ``x`` shape (dim, N) in state units."""
    return multilinear_interp(fun_vals, uniform_grid_coords(grids, x))
