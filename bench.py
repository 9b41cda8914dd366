"""Operator throughput on one GPU: the factored discrete SSY operator
against the reference's broadcast formulation.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}

* Workload: 200 successive-approximation applications of the discrete SSY
  Koopmans operator on the reference's own (10,10,10,10) Rouwenhorst grid
  (``sandpit.ipynb``) in log space at f64, as one device-resident loop.
* ``value``: this framework's throughput in grid-point updates per second
  (N * iters / seconds, median of 3 timed runs, compile excluded).
* ``vs_baseline``: speedup over the reference's broadcast-H formulation
  (reimplemented in ``benchmarks/reference_style.py``) running the
  identical loop on the same card.
* ``device``: JAX's platform, device kind and count, and the card's name
  and power limit from ``nvidia-smi``.

Correctness gate: one application of each operator must agree to 1e-10
(the factored operator itself is validated against loop oracles, a dense-H
path, and end-to-end solves in tests/).  Exits 2 without a result when
JAX's default device is not a GPU.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

from benchmarks.cards import card_names

SHAPES = (10, 10, 10, 10)
ITERS = 200


def median_time(fn, n=3):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def main():
    from benchmarks.reference_style import T_ssy_reference_style
    from sdfs_via_autodiff_tpu import SSY, T_ssy_factory, discretize_ssy, solve

    cards = card_names()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"refusing to run: the default JAX device is {dev.platform!r}, "
              "not a GPU", file=sys.stderr)
        return 2
    device = dict(platform=dev.platform, kind=dev.device_kind,
                  count=len(jax.devices()), cards=cards)

    model = SSY()
    disc = discretize_ssy(model, SHAPES)
    ell0 = jnp.full(SHAPES, jnp.log(800.0))
    n_points = 1
    for s in SHAPES:
        n_points *= s

    T_fac = T_ssy_factory(model, disc, space="log")
    T_ref = T_ssy_reference_style(model, disc, space="log")

    # Fixed-iteration-count loops (tol=0 never triggers).
    run_fac = lambda: solve(T_fac, ell0, method="successive_approx",
                            tol=0.0, max_iter=ITERS).x
    run_ref = lambda: solve(T_ref, ell0, method="successive_approx",
                            tol=0.0, max_iter=ITERS).x

    # Correctness gate: the two formulations compute the same operator.
    err = float(jnp.max(jnp.abs(T_fac(ell0) - T_ref(ell0))))
    if not err < 1e-10:
        print(json.dumps({"metric": "ssy_discrete_T_throughput",
                          "value": None, "unit": "grid-point-updates/s",
                          "vs_baseline": None, "device": device,
                          "error": f"operators differ by {err}"}))
        return 1

    jax.block_until_ready(run_fac())   # compile
    jax.block_until_ready(run_ref())
    t_fac = median_time(run_fac)
    t_ref = median_time(run_ref)
    print(json.dumps({
        "metric": "ssy_discrete_T_throughput_10^4_logspace_f64",
        "value": n_points * ITERS / t_fac,
        "unit": "grid-point-updates/s",
        "vs_baseline": t_ref / t_fac,
        "ours_s_per_200_iters": t_fac,
        "reference_formulation_s_per_200_iters": t_ref,
        "one_application_sup_diff": err,
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
