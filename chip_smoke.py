"""Smoke test of the main solve path on an NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py              # phases P1-P5 on one card
    python chip_smoke.py --devices 4  # the sharded phase on four cards

Every phase runs in float64 and log space through the public drivers and
checks what it produced against a plain reference:

  P1  discrete SSY (10,10,10,10), Newton: one application of the factored
      operator against the broadcast formulation of the reference
      (benchmarks/reference_style.py), and the residual of w* under it.
  P2  discrete GCY (3,)*6, Newton: residual of w* under the dense-H
      operator (dense_H_gcy).
  P3  continuous SSY (15,)*4 and (20,)*4, Newton: one-step simulated
      moments of w* against the reference's published values.
  P4  discrete SSY (32,32,32,32), 1.05M points, Newton: residual of the
      card's w* under the same operator evaluated on the host CPU.
  P5  one application of the per-axis operator at (56,56,56,64), 11.2M
      points, in float64 and float32: time per application and the
      float32 error.

The phases run in the order P2, P3, P4, P5, P1, which is that of the device
memory they need: a device's peak memory is the process's since it
started, so each phase's line says whether the phase raised it.

``--devices 4`` runs only the sharded phase: a GSPMD-sharded Newton solve
on a 4x1 mesh against the same solve on one card, and the explicit
shard_map operator against the single-device one.

The script exits non-zero, and prints no result line, when JAX's default
device is not a GPU or when any check fails.  Its last line is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

from benchmarks.cards import card_names

# P4 checks the card's result on the host CPU, so the CPU backend must be
# present beside the GPU.  Where JAX_PLATFORMS names platforms explicitly,
# add "cpu" after them: the first one stays the default device, and JAX
# still fails at start-up if it cannot be initialised.
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

LOG_W0 = math.log(800.0)   # the reference's start iterate w = 800


class Check:
    """One gated comparison: passes when ``value`` is finite and at most
    ``tol``."""

    def __init__(self, name: str, value: float, tol: float):
        self.name, self.value, self.tol = name, float(value), float(tol)
        self.ok = math.isfinite(self.value) and self.value <= self.tol

    def as_dict(self):
        return dict(name=self.name, value=self.value, tol=self.tol,
                    ok=self.ok)


def sup_diff(a, b) -> float:
    import numpy as np
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def rel_err(value: float, anchor: float) -> float:
    return abs(value - anchor) / abs(anchor)


def memory(device=None):
    """(bytes_in_use, peak_bytes_in_use) of a device; None where the
    backend keeps no such statistics.  The peak is the process's, since
    it started: it never falls."""
    import jax
    stats = (device or jax.devices()[0]).memory_stats() or {}
    return stats.get("bytes_in_use"), stats.get("peak_bytes_in_use")


def peak_bytes(device=None):
    return memory(device)[1]


def timed_twice(fn):
    """Run ``fn`` twice; each call ends with block_until_ready on the
    solution.  Returns (second result, first-call s, second-call s)."""
    import jax

    times, out = [], None
    for _ in range(2):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready((out.w_star, out.result))
        times.append(time.perf_counter() - t0)
    return out, times[0], times[1]


def solve_record(sol, shape, algorithm, first_s, second_s):
    import numpy as np
    return dict(shape=list(shape), points=int(np.prod(shape)),
                algorithm=algorithm,
                iterations=int(sol.result.iterations),
                residual=float(sol.result.residual),
                converged=bool(sol.converged),
                first_call_s=first_s, second_call_s=second_s)


def phase_discrete_ssy(shapes=(10, 10, 10, 10), tol=1e-7):
    """P1: discrete SSY against the reference's broadcast formulation."""
    import jax.numpy as jnp

    from benchmarks.reference_style import T_ssy_reference_style
    from sdfs_via_autodiff_tpu import (SSY, T_ssy_factory, discretize_ssy,
                                       wc_ratio_discrete)

    model = SSY()
    sol, t1, t2 = timed_twice(lambda: wc_ratio_discrete(
        model, shapes, algorithm="newton", tol=tol))
    disc = discretize_ssy(model, shapes)
    ell = jnp.log(sol.w_star)
    T_fac = T_ssy_factory(model, disc, space="log")
    T_ref = T_ssy_reference_style(model, disc, space="log")
    ref_ell = T_ref(ell)
    rec = solve_record(sol, shapes, "newton", t1, t2)
    checks = [Check("factored_vs_broadcast_sup_log_w",
                    sup_diff(T_fac(ell), ref_ell), 1e-10),
              Check("residual_under_broadcast_sup_log_w",
                    sup_diff(ref_ell, ell), tol)]
    return rec, checks


def dense_T_log(H, theta, beta):
    """Plain log-space operator on a dense (N, N) H: log T(w) with
    T(w) = 1 + beta (H w^theta)^(1/theta), one global shift."""
    import jax.numpy as jnp

    def T(ell):
        a = theta * ell.reshape(-1)
        m = jnp.max(a)
        log_hwt = m + jnp.log(H @ jnp.exp(a - m))
        return jnp.log1p(beta * jnp.exp(log_hwt / theta)).reshape(ell.shape)

    return T


def phase_discrete_gcy(shapes=(3,) * 6, tol=1e-7):
    """P2: discrete GCY against the dense-H operator."""
    import jax.numpy as jnp

    from sdfs_via_autodiff_tpu import (GCY, dense_H_gcy, discretize_gcy,
                                       wc_ratio_discrete)

    model = GCY()
    sol, t1, t2 = timed_twice(lambda: wc_ratio_discrete(
        model, shapes, algorithm="newton", tol=tol))
    disc = discretize_gcy(model, shapes)
    T_dense = dense_T_log(dense_H_gcy(model, disc), model.theta, model.beta)
    ell = jnp.log(sol.w_star)
    rec = solve_record(sol, shapes, "newton", t1, t2)
    checks = [Check("residual_under_dense_H_sup_log_w",
                    sup_diff(T_dense(ell), ell), tol)]
    return rec, checks


# The reference's published one-step simulated moments of w*
# (test_newton.md:217-238), with the bands of
# tests/test_reference_anchors.py: 1e-3 relative on the mean, 5e-3 on
# the standard deviation.
ANCHOR_CASES = (
    ((15, 15, 15, 15), 3.2, 5, (670.75128139, 6.60051464)),
    ((20, 20, 20, 20), 2.5, 8, (976.43571268, 8.62554633)),
)


def phase_continuous_ssy(cases=ANCHOR_CASES, num_draws=1_000_000,
                         tol=1e-9):
    """P3: continuous SSY against the reference's moment anchors."""
    from sdfs_via_autodiff_tpu import (SSY, construct_wstar_callable,
                                       one_step_w_moments,
                                       wc_ratio_continuous)

    model = SSY()
    recs, checks = [], []
    for sizes, std, degree, (mean_ref, std_ref) in cases:
        sol, t1, t2 = timed_twice(lambda: wc_ratio_continuous(
            model, sizes, num_std_devs=std, quad_degree=degree,
            interp="pre", algorithm="newton", tol=tol))
        f = construct_wstar_callable(sol.w_star, sol.grids)
        mean, stdev = one_step_w_moments(model, f, num_draws=num_draws)
        rec = solve_record(sol, sizes, "newton", t1, t2)
        rec.update(num_std_devs=std, quad_degree=degree, mean=mean,
                   std=stdev, anchor=[mean_ref, std_ref])
        recs.append(rec)
        tag = "x".join(map(str, sizes))
        checks += [Check(f"{tag}_mean_rel_err", rel_err(mean, mean_ref),
                         1e-3),
                   Check(f"{tag}_std_rel_err", rel_err(stdev, std_ref),
                         5e-3),
                   Check(f"{tag}_converged", 0.0 if sol.converged else 1.0,
                         0.0)]
    return recs, checks


def phase_scale(shapes=(32, 32, 32, 32), tol=1e-7):
    """P4: 1.05M-point discrete SSY, checked on the host CPU."""
    import jax
    import jax.numpy as jnp

    from sdfs_via_autodiff_tpu import (SSY, T_ssy_factory, discretize_ssy,
                                       wc_ratio_discrete)

    model = SSY()
    sol, t1, t2 = timed_twice(lambda: wc_ratio_discrete(
        model, shapes, algorithm="newton", tol=tol))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        T_cpu = T_ssy_factory(model, discretize_ssy(model, shapes),
                              space="log")
        ell = jax.device_put(jnp.log(sol.w_star), cpu)
        residual = sup_diff(T_cpu(ell), ell)
    rec = solve_record(sol, shapes, "newton", t1, t2)
    checks = [Check("residual_on_host_cpu_sup_log_w", residual, tol)]
    return rec, checks


# float32 one-application error bound on log w: f32 rounding (~6e-8
# relative) of theta*ell (|theta*ell| ~ 1e2) enters each of the four
# log-sum-exp passes, and leaving the theta-power divides by |theta|;
# 1e-4 leaves a wide margin over that ~1e-5 estimate.
F32_ONE_APP_BOUND = 1e-4


def phase_plain_chain(shapes=(56, 56, 56, 64), n_apps=10, n_calls=5):
    """P5: time of one application of the per-axis operator."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    from sdfs_via_autodiff_tpu import SSY, T_ssy_factory, discretize_ssy

    model = SSY()
    disc = discretize_ssy(model, shapes)
    rec = dict(shape=list(shapes), points=int(np.prod(shapes)),
               apps_per_call=n_apps, calls=n_calls)
    outs = {}
    for name, dtype in (("f64", jnp.float64), ("f32", jnp.float32)):
        T = T_ssy_factory(model, disc, space="log", dtype=dtype)
        ell0 = jnp.full(shapes, LOG_W0, dtype)
        many = jax.jit(lambda x, T=T: lax.fori_loop(
            0, n_apps, lambda i, v: T(v), x))
        t0 = time.perf_counter()
        jax.block_until_ready(many(ell0))
        rec[f"{name}_compile_s"] = time.perf_counter() - t0
        times = []
        for _ in range(n_calls):
            t0 = time.perf_counter()
            jax.block_until_ready(many(ell0))
            times.append(time.perf_counter() - t0)
        rec[f"{name}_ms_per_app"] = 1e3 * statistics.median(times) / n_apps
        outs[name] = np.asarray(T(ell0), np.float64)
    checks = [Check("f64_output_nonfinite_count",
                    float(np.sum(~np.isfinite(outs["f64"]))), 0.0),
              Check("f32_output_nonfinite_count",
                    float(np.sum(~np.isfinite(outs["f32"]))), 0.0),
              Check("f32_vs_f64_sup_log_w", sup_diff(outs["f32"],
                                                     outs["f64"]),
                    F32_ONE_APP_BOUND)]
    return rec, checks


def phase_sharded(n_devices=4, shapes=(32, 32, 32, 32), tol=1e-7):
    """Four-card phase: GSPMD-sharded Newton against one card, and the
    explicit shard_map operator against the single-device operator.

    The mesh is 4x1: the iterate is sharded over its leading (h_lam)
    axis only.  Every card reaches every other over NVLink at one rate,
    so the mesh follows the algorithm, and sharding one grid axis puts
    collectives on one contraction of the four per application, where a
    2x2 mesh would put them on two."""
    import jax
    import jax.numpy as jnp

    from sdfs_via_autodiff_tpu import (SSY, T_ssy_factory, discretize_ssy,
                                       wc_ratio_discrete)
    from sdfs_via_autodiff_tpu.parallel.mesh import make_mesh, shard_grid_array
    from sdfs_via_autodiff_tpu.parallel.shard_ops import (
        T_ssy_shard_map_factory)

    model = SSY()
    mesh = make_mesh(n_devices, shape=(n_devices, 1))
    w0 = jnp.full(shapes, 800.0)
    sol_sh, t1, t2 = timed_twice(lambda: wc_ratio_discrete(
        model, shapes, algorithm="newton", tol=tol,
        w_init=shard_grid_array(w0, mesh)))
    sol_1 = wc_ratio_discrete(model, shapes, algorithm="newton", tol=tol,
                              w_init=jax.device_put(w0, jax.devices()[0]))
    disc = discretize_ssy(model, shapes)
    ell_1 = jnp.log(sol_1.w_star)
    T_sm = T_ssy_shard_map_factory(model, disc, mesh, axis_name="dp")
    T_1 = T_ssy_factory(model, disc, space="log")
    sm_out = T_sm(jax.device_put(ell_1, T_sm.input_sharding))
    sharding = sol_sh.result.x.sharding
    rec = solve_record(sol_sh, shapes, "newton", t1, t2)
    rec.update(mesh=dict(mesh.shape),
               iterate_spec=str(getattr(sharding, "spec", sharding)),
               single_iterations=int(sol_1.result.iterations),
               peak_bytes_per_device=[peak_bytes(d)
                                      for d in jax.devices()[:n_devices]])
    checks = [Check("iterate_replicated",
                    1.0 if sharding.is_fully_replicated else 0.0, 0.0),
              Check("sharded_vs_single_sup_log_w",
                    sup_diff(jnp.log(sol_sh.w_star), ell_1), 1e-10),
              Check("shard_map_vs_single_operator_sup_log_w",
                    sup_diff(sm_out, T_1(ell_1)), 1e-10),
              Check("sharded_residual_sup_log_w",
                    float(sol_sh.result.residual), tol)]
    return rec, checks


def run_phase(name, fn, **kwargs) -> bool:
    """Run one phase, print its line, and say whether all checks held.

    The device's peak is the process's since it started, so the line
    says whether this phase raised it (``peak_set_by_phase``): only then
    is ``peak_bytes_in_use`` the phase's own peak."""
    _, peak_before = memory()
    try:
        rec, checks = fn(**kwargs)
    except Exception as e:                    # reported, then gated
        print(f"{name} FAILED {type(e).__name__}: {e}", flush=True)
        return False
    in_use, peak = memory()
    ok = all(c.ok for c in checks)
    print(f"{name} " + json.dumps(dict(
        ok=ok, result=rec, checks=[c.as_dict() for c in checks],
        peak_bytes_in_use=peak,
        peak_set_by_phase=None if peak is None else peak > (peak_before or 0),
        bytes_in_use_after=in_use)), flush=True)
    return ok


def result_line(dev, count: int) -> str:
    """The last line: ok, and the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}})


# In order of the device memory each phase needs, so that each can set
# the process's peak itself: P1 runs last because its broadcast H holds
# 800 MB.
ONE_CARD_PHASES = (("P2_discrete_gcy", phase_discrete_gcy),
                   ("P3_continuous_ssy", phase_continuous_ssy),
                   ("P4_scale_1M", phase_scale),
                   ("P5_plain_chain", phase_plain_chain),
                   ("P1_discrete_ssy", phase_discrete_ssy))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, choices=(1, 4), default=1,
                   help="4: run only the sharded phase on four cards")
    args = p.parse_args(argv)

    cards = card_names()
    import jax
    import jaxlib

    import sdfs_via_autodiff_tpu  # noqa: F401  (sets the compile cache)
    print(f"card: {cards} | jax {jax.__version__} jaxlib "
          f"{jaxlib.__version__} | compile cache "
          f"{jax.config.jax_compilation_cache_dir}", flush=True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"refusing to run: the default JAX device is "
              f"{dev.platform!r} ({dev.device_kind}), not a GPU",
              flush=True)
        return 2
    if len(jax.devices()) < args.devices:
        print(f"refusing to run: {args.devices} GPUs requested, "
              f"{len(jax.devices())} present", flush=True)
        return 2

    if args.devices == 1:
        phases = ONE_CARD_PHASES
    else:
        phases = (("P6_sharded_4x1", phase_sharded),)
    results = [run_phase(name, fn) for name, fn in phases]
    if not all(results):
        print("FAILED: " + ", ".join(
            name for (name, _), ok in zip(phases, results) if not ok),
            flush=True)
        return 1
    print(result_line(dev, args.devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
