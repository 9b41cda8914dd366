"""Calibration sweep demo: many parameterizations, one compiled solve.

``wc_ratio_sweep`` stacks the model parameters and each calibration's
own grids, traces the factored-quadrature operator construction over
them, and vmaps the whole build-and-solve — one compile covers the
sweep.  The reference solves calibrations one notebook run at a time
(``/root/reference/code/ssy/continuous_junnan/ssy_test_continuous.md``);
a gamma sweep like this one is the moment-matching workflow that makes
the batched form worth sharding one member per device.

Run:  python examples/sweep_demo.py
"""

import dataclasses
import time

import jax.numpy as jnp


def main():
    from sdfs_via_autodiff_tpu import SSY, wc_ratio_sweep

    gammas = [7.5, 8.0, 8.5, 8.89, 9.5]
    models = [dataclasses.replace(SSY(), gamma=g) for g in gammas]
    t0 = time.time()
    w, res, _ = wc_ratio_sweep(models, (10, 10, 10, 12), quad_degree=5,
                               tol=1e-9)
    dt = time.time() - t0
    print(f"solved {len(models)} calibrations in one compile: "
          f"{dt:.1f}s total ({dt/len(models):.2f}s each, incl. compile)")
    for g, wi, it, conv in zip(gammas, w, res.iterations, res.converged):
        print(f"  gamma={g:5.2f}: iters={int(it):2d} "
              f"converged={bool(conv)} "
              f"E-ish[w] ~ {float(jnp.mean(wi)):8.2f} "
              f"w in [{float(wi.min()):7.2f}, {float(wi.max()):8.2f}]")


if __name__ == "__main__":
    main()
