"""Multi-device grid sharding demo (runs on a virtual CPU mesh anywhere).

Set XLA_FLAGS=--xla_force_host_platform_device_count=8 (and run on CPU)
to emulate an 8-device mesh; on a host with several GPUs it uses the
actual cards.  Shows both multi-device paths: GSPMD-partitioned operators and
the explicit shard_map program with hand-placed collectives.
"""

import jax
import jax.numpy as jnp
import numpy as np

from sdfs_via_autodiff_tpu import SSY, T_ssy_factory, discretize_ssy, solve
from sdfs_via_autodiff_tpu.parallel.mesh import make_mesh, shard_grid_array
from sdfs_via_autodiff_tpu.parallel.shard_ops import T_ssy_shard_map_factory


def main():
    n = jax.device_count()
    print(f"devices: {n} x {jax.devices()[0].platform}")
    model = SSY()
    shapes = (8, 8, 6, 6)
    disc = discretize_ssy(model, shapes)
    T = T_ssy_factory(model, disc, space="log")
    ell0 = jnp.full(shapes, jnp.log(800.0))

    # Single-device reference.
    ref = solve(T, ell0, method="newton", tol=1e-10)
    print(f"single-device newton: {ref}")

    if n >= 2:
        mesh = make_mesh(min(n, 8))
        print(f"mesh: {dict(mesh.shape)}")
        # GSPMD: shard the iterate, same operator, XLA inserts collectives.
        res = solve(T, shard_grid_array(ell0, mesh), method="newton",
                    tol=1e-10)
        diff = float(jnp.max(jnp.abs(res.x - ref.x)))
        print(f"GSPMD sharded newton:  {res}  (sup diff vs single {diff:.2e})")

        # Explicit shard_map with pmax + psum_scatter collectives.
        mesh1d = make_mesh(min(n, 8), shape=(min(n, 8), 1))
        T_manual = T_ssy_shard_map_factory(model, disc, mesh1d)
        ell_sh = jax.device_put(ell0, T_manual.input_sharding)
        res2 = solve(T_manual, ell_sh, method="newton", tol=1e-10)
        diff2 = float(jnp.max(jnp.abs(res2.x - ref.x)))
        print(f"shard_map newton:      {res2}  (sup diff vs single {diff2:.2e})")


if __name__ == "__main__":
    main()
