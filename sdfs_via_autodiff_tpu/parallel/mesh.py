"""Device mesh construction and grid-axis sharding.

The workload's scaling axis is state-grid size (SURVEY.md §5): w lives on a
tensor-product grid, and every operator is a chain of per-axis contractions
of w against small transition factors.  The parallelism is therefore *grid
sharding*: lay w out over a device mesh with ``NamedSharding`` on one or two
grid axes and let GSPMD partition the contraction chain — per-axis matmuls
over a sharded axis become local partial matmuls plus XLA-inserted
collectives, and the solvers' sup-norm reductions compile to a max across
devices.  The reference has no multi-device path at all (single device,
``CUDA_VISIBLE_DEVICES`` pinning only — SURVEY.md §2 parallelism table).

Two mesh axes are exposed, named ``dp`` and ``tp`` by convention:

* ``dp`` shards the leading *current-state* grid axis of w — the
  data-parallel analogue (each device owns a block of states);
* ``tp`` shards a second grid axis, giving 2-D layouts for larger meshes —
  the tensor-parallel analogue (the contraction over a sharded axis is a
  sharded matmul + reduction).

The cards of one host are joined all to all, so the mesh shape follows the
algorithm: a 4x1 mesh shards one grid axis and puts collectives on one
contraction of the chain, where 2x2 puts them on two.  Tested on virtual CPU
meshes (``--xla_force_host_platform_device_count``) and on four cards by
``chip_smoke.py --devices 4``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["make_mesh", "grid_sharding", "shard_grid_array",
           "replicated_sharding"]


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, str] = ("dp", "tp"),
              shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """Build a 2-D device mesh over the first ``n_devices`` devices.

    ``shape`` fixes the (dp, tp) factorization explicitly; the default
    splits the device count into the most-square factorization with dp the
    larger axis (8 -> 4x2, 4 -> 2x2, 2 -> 2x1, 1 -> 1x1).
    """
    devices = jax.devices()
    n = len(devices) if n_devices is None else n_devices
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    if shape is None:
        tp = 1
        for cand in range(int(np.sqrt(n)), 0, -1):
            if n % cand == 0:
                tp = cand
                break
        shape = (n // tp, tp)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    dev_array = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev_array, axis_names)


def grid_sharding(mesh: Mesh, ndim: int,
                  axis_map: Optional[dict] = None) -> NamedSharding:
    """NamedSharding placing mesh axes onto grid axes of a rank-``ndim`` w.

    ``axis_map`` maps array axis -> mesh axis name; the default puts
    ``dp`` on axis 0 and ``tp`` (if the mesh has more than one device on
    it) on axis 1.
    """
    if axis_map is None:
        axis_map = {0: mesh.axis_names[0]}
        if len(mesh.axis_names) > 1 and mesh.shape[mesh.axis_names[1]] > 1:
            axis_map[1] = mesh.axis_names[1]
    spec = [axis_map.get(d) for d in range(ndim)]
    return NamedSharding(mesh, PartitionSpec(*spec))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard_grid_array(w, mesh: Mesh, axis_map: Optional[dict] = None):
    """Place w on the mesh with :func:`grid_sharding` (pads nothing — grid
    axes should be divisible by the mesh axes they map to)."""
    sharding = grid_sharding(mesh, np.ndim(w), axis_map)
    return jax.device_put(w, sharding)
