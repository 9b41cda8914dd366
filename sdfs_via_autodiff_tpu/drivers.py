"""High-level drivers: model -> grids -> operator -> solver -> checkpoint.

End-to-end parity with the reference drivers ``wc_ratio_continuous``
(``ssy_wc_ratio_continuous.py:229-297``, ``gcy_wc_ratio_continuous.py:
264-335``) and the discrete test drivers (``ssy_wc_ratio.py:216-240``,
``gcy_wc_ratio.py:319-340``), with a structured result instead of prints,
checkpointing via :mod:`.utils.checkpoint`, and a log-space default for the
iterate: solving on ell = log w enforces w > 0 (Newton in w space can step
to negative w, where w^theta is undefined), keeps float32 solves inside the
exponent range (w^theta underflows it), and reproduces the w-space fixed
point to ~1e-12 relative.  Pass ``space="w"`` for strict reference
semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from .models.gcy import GCY
from .models.ssy import SSY
from .operators.continuous_gcy import T_gcy_continuous_factory, build_grid_gcy
from .operators.continuous_ssy import T_ssy_continuous_factory, build_grid_ssy
from .operators.discrete_gcy import T_gcy_factory, discretize_gcy
from .operators.discrete_ssy import T_ssy_factory, discretize_ssy
from .solvers import SolveResult, solve
from .utils.checkpoint import save_solution

__all__ = ["WCSolution", "wc_ratio_discrete", "wc_ratio_continuous",
           "wc_ratio_continuation", "wc_ratio_sweep", "prolong_w",
           "DeGrootSolution", "degroot_fixed_point"]

DEFAULT_INIT_W = 800.0   # reference w_init, ssy_wc_ratio.py:233


@dataclasses.dataclass
class WCSolution:
    """Wealth-consumption-ratio solve output: w* plus how we got it."""
    w_star: jnp.ndarray
    grids: Optional[Tuple[jnp.ndarray, ...]]
    result: SolveResult
    space: str

    @property
    def converged(self) -> bool:
        return bool(self.result.converged)


def _auto_space() -> str:
    # Log space is the robust default everywhere (see module docstring);
    # this hook exists so the policy is overridable in one place.
    return "log"


def f32_tol_floor(theta: Optional[float]) -> float:
    """Practical float32 sup-norm floor of the log iterate, scaled by the
    risk-aversion exponent theta.

    The per-application f32 bias (~3 ulp of the log iterate) amplifies by
    the fixed-point factor 1/(1-rate) into the solution (docs/precision.md);
    the attainable residual floor additionally grows with |theta| because
    w = 1 + beta (H w^theta)^(1/theta) wraps every evaluation in a
    theta-power round trip.  Observed float32 solves: SSY (theta ~ -16)
    stalls below ~5e-6; GCY (theta ~ -36) stalls at tol 2.2e-5 and
    converges at 3e-5 — consistent with a quadratic |theta| scaling from
    the two theta-scaled transcendental round trips per application.
    """
    if theta is None:
        return 5e-6
    return 5e-6 * max(1.0, (abs(float(theta)) / 16.0) ** 2)


def _newton_applicable(solver_opts: dict) -> dict:
    """Subset of user solver options accepted by the Newton solver — the
    polish stages always refine with Newton, whatever the fast stage ran."""
    import inspect

    from .solvers.fixed_point import newton_solver
    allowed = set(inspect.signature(newton_solver).parameters) - {"T", "x0"}
    return {k: v for k, v in solver_opts.items() if k in allowed}


def _run_solver(T, w0, space, algorithm, tol, solver_opts,
                theta: Optional[float] = None) -> WCSolution:
    import warnings
    floor = f32_tol_floor(theta)
    if jnp.result_type(w0) == jnp.float32 and tol < floor:
        warnings.warn(
            f"tol={tol:g} is below the float32 iteration floor "
            f"(~{floor:.0e} on the log iterate for theta={theta}); the "
            "solve may stall (stall guard -> converged=False). Use "
            "float64, polish=True, or relax tol.", stacklevel=3)
    if space == "log":
        x0 = jnp.log(w0)
        res = solve(T, x0, method=algorithm, tol=tol, **solver_opts)
        w_star = jnp.exp(res.x)
    else:
        res = solve(T, w0, method=algorithm, tol=tol, **solver_opts)
        w_star = res.x
    return WCSolution(w_star=w_star, grids=None, result=res, space=space)


def _check_polish(polish) -> bool:
    if not isinstance(polish, bool):
        raise ValueError(f"polish must be True or False, got {polish!r}")
    return polish


def wc_ratio_discrete(model,
                      shapes: Sequence[int],
                      *,
                      algorithm: str = "newton",
                      tol: float = 1e-7,
                      space: Optional[str] = None,
                      w_init=None,
                      dtype=None,
                      baseline: Optional[str] = None,
                      discretization: str = "rouwenhorst",
                      polish: bool = False,
                      checkpoint_path: Optional[str] = None,
                      **solver_opts) -> WCSolution:
    """Solve the discretized (Rouwenhorst tensor-grid) model.

    Parity: reference ``test_compute_wc_ratio_ssy`` / ``..._gcy``
    (``ssy_wc_ratio.py:216-240``, ``gcy_wc_ratio.py:319-340``).

    ``polish=True`` (meaningful for float32 solves): after the fast
    solve, refine with float64 Newton warm-started from it, on the
    default device — the same two-stage recipe as the continuous
    driver's polish (reference default tol 1e-7, ``solvers.py:16``,
    despite the float32 tier's ~1e-5 floor).

    ``baseline="loglinear"`` folds the log-linear closed form into the
    operator (log space), extending float32 coverage to wide Rouwenhorst
    grids.

    ``discretization="tauchen"`` swaps the Rouwenhorst construction for
    Tauchen's: its grid spans a fixed ±3 unconditional std at ANY point
    count, making fine f32 discrete grids range-safe (Rouwenhorst
    ladders widen like ±sqrt(n-1) sigma — keep h-axes at <=32 points
    there).
    """
    space = space or _auto_space()
    if _check_polish(polish):
        fast = wc_ratio_discrete(
            model, shapes, algorithm=algorithm, tol=max(tol, 1e-4),
            space=space, w_init=w_init, dtype=dtype,
            baseline=baseline, discretization=discretization,
            **solver_opts)
        # f64 Newton refine; baseline intentionally dropped — f64 needs
        # no range fold (see the continuous twin).
        return wc_ratio_discrete(
            model, shapes, algorithm="newton", tol=tol, space="log",
            discretization=discretization,
            w_init=fast.w_star.astype(jnp.float64),
            checkpoint_path=checkpoint_path,
            **_newton_applicable(solver_opts))
    # The discretization is always built in float64: the grid ladders
    # define the discrete model, and f32-rounded ladders shift its fixed
    # point by up to ~1e-2 after the beta ~ 1 amplification (measured on
    # wide GCY grids).  ``dtype`` only selects the operator's working
    # precision — the factories cast the arrays.
    if isinstance(model, SSY):
        disc = discretize_ssy(model, tuple(shapes), method=discretization)
        T = T_ssy_factory(model, disc, space=space, dtype=dtype,
                          baseline=baseline)
    elif isinstance(model, GCY):
        disc = discretize_gcy(model, tuple(shapes), method=discretization)
        T = T_gcy_factory(model, disc, space=space, dtype=dtype,
                          baseline=baseline)
    else:
        raise TypeError(f"unsupported model {type(model).__name__}")

    w0 = (jnp.full(tuple(shapes), DEFAULT_INIT_W, dtype=dtype or jnp.float64)
          if w_init is None else jnp.asarray(w_init))
    sol = _run_solver(T, w0, space, algorithm, tol, solver_opts,
                          theta=model.theta)
    if checkpoint_path:
        save_solution(checkpoint_path, model, (), sol.w_star,
                      meta=dict(kind="discrete", shapes=list(shapes),
                                algorithm=algorithm, tol=tol, space=space,
                                iterations=int(sol.result.iterations),
                                residual=float(sol.result.residual)))
    return sol


def wc_ratio_continuous(model,
                        grid_sizes: Sequence[int],
                        *,
                        num_std_devs: float = 3.2,
                        method: str = "quadrature",
                        interp: str = "pre",
                        quad_degree: int = 5,
                        mc_draw_size: int = 2000,
                        seed: int = 1234,
                        algorithm: str = "newton",
                        tol: float = 1e-7,
                        space: Optional[str] = None,
                        w_init=None,
                        batch_size: Optional[int] = None,
                        baseline: Optional[str] = None,
                        dtype=None,
                        engine: str = "auto",
                        polish: bool = False,
                        checkpoint_path: Optional[str] = None,
                        **solver_opts) -> WCSolution:
    """Solve the continuous-state model on interpolation grids.

    ``engine`` selects the evaluation strategy for post/loglin
    semantics: "auto" (node-chain matmuls in log space), or "gather"
    (the reference's pointwise corner-gather formulation).

    Parity: reference ``wc_ratio_continuous``
    (``ssy_wc_ratio_continuous.py:229-297``); grid bounds via
    ``num_std_devs`` stationary standard deviations, Gauss-Hermite degree
    ``quad_degree`` per dimension or ``mc_draw_size`` Monte Carlo draws,
    initial guess all-ones (reference :243-245) unless ``w_init`` given.

    ``baseline="coarse"`` (the float32 production recipe, and required
    for GCY in f32 where theta*(log-w range) exceeds the f32 exponential
    range): solves a small float64 model first, fits an additive
    (ANOVA main-effects) baseline from it, folds it into the operator,
    and warm-starts from it.  ``baseline="loglinear"`` folds the closed
    form instead (adequate for SSY).

    ``polish=True`` (meaningful for float32 solves): after the fast
    solve, refine with float64 Newton warm-started from it, on the
    default device — the f32 tier's speed with the f64 tier's accuracy.
    """
    space = space or _auto_space()
    gdtype = dtype or jnp.float64
    if _check_polish(polish):
        fast = wc_ratio_continuous(
            model, grid_sizes, num_std_devs=num_std_devs, method=method,
            interp=interp, quad_degree=quad_degree,
            mc_draw_size=mc_draw_size, seed=seed, algorithm=algorithm,
            tol=max(tol, 1e-4), space=space, w_init=w_init,
            batch_size=batch_size, baseline=baseline, dtype=dtype,
            engine=engine, **solver_opts)
        # The polish stage reruns the same configuration at float64 with
        # interp-engine settings and the Newton-applicable user solver
        # options forwarded (the polish algorithm is always Newton, so
        # e.g. Anderson-history options from an algorithm="anderson" fast
        # stage are dropped); ``baseline`` is intentionally dropped too
        # (it exists to keep f32 in range — f64 doesn't need the fold, and
        # skipping it keeps strict reference operator semantics for the
        # final residual).
        return wc_ratio_continuous(
            model, grid_sizes, num_std_devs=num_std_devs, method=method,
            interp=interp, quad_degree=quad_degree,
            mc_draw_size=mc_draw_size, seed=seed, algorithm="newton",
            tol=tol, space="log", batch_size=batch_size, engine=engine,
            w_init=fast.w_star.astype(jnp.float64),
            checkpoint_path=checkpoint_path,
            **_newton_applicable(solver_opts))
    baseline_spec = baseline
    if baseline == "coarse":
        baseline_spec = _coarse_additive_baseline(
            model, grid_sizes, num_std_devs=num_std_devs,
            quad_degree=quad_degree, dtype=gdtype)
    if isinstance(model, SSY):
        grids = build_grid_ssy(model, *grid_sizes, num_std_devs=num_std_devs,
                               dtype=gdtype)
        T = T_ssy_continuous_factory(
            model, grids, method=method, interp=interp, space=space,
            quad_degree=quad_degree, mc_draw_size=mc_draw_size, seed=seed,
            batch_size=batch_size, baseline=baseline_spec, dtype=dtype,
            engine=engine)
    elif isinstance(model, GCY):
        grids = build_grid_gcy(model, *grid_sizes, num_std_devs=num_std_devs,
                               dtype=gdtype)
        T = T_gcy_continuous_factory(
            model, grids, method=method, interp=interp, space=space,
            quad_degree=quad_degree, mc_draw_size=mc_draw_size, seed=seed,
            batch_size=batch_size, baseline=baseline_spec, dtype=dtype)
    else:
        raise TypeError(f"unsupported model {type(model).__name__}")

    shape = tuple(len(g) for g in grids)
    if w_init is None:
        w0 = (jnp.exp(T.baseline_log_w)
              if hasattr(T, "baseline_log_w")
              else jnp.ones(shape, dtype=gdtype))
    else:
        w0 = jnp.asarray(w_init)
    sol = _run_solver(T, w0, space, algorithm, tol, solver_opts,
                          theta=model.theta)
    sol = dataclasses.replace(sol, grids=tuple(grids))
    if checkpoint_path:
        save_solution(checkpoint_path, model, grids, sol.w_star,
                      meta=dict(kind="continuous", method=method,
                                interp=interp, quad_degree=quad_degree,
                                num_std_devs=num_std_devs,
                                algorithm=algorithm, tol=tol, space=space,
                                iterations=int(sol.result.iterations),
                                residual=float(sol.result.residual)))
    return sol


def wc_ratio_sweep(models: Sequence,
                   grid_sizes: Sequence[int],
                   *,
                   num_std_devs: float = 3.2,
                   quad_degree: int = 5,
                   algorithm: str = "newton",
                   tol: float = 1e-7,
                   space: str = "log",
                   w_init=None,
                   dtype=None,
                   **solver_opts):
    """Solve MANY calibrations of one model family in a single compiled
    program — build-operator-and-solve, vmapped over the stacked model
    parameters (and each calibration's own grids).

    The natural consumer of a calibration sweep (e.g. a gamma/psi grid
    for moment matching): one compile covers the whole sweep, and the
    leading sweep axis is the natural one to shard one member per device
    (the reference solves calibrations one notebook run at a time).

    Covers the factored quadrature interp="pre" chain (the one operator
    construction that is jnp-traceable end to end over model
    parameters); ``baseline`` folds are not supported in a sweep — the
    log-linear closed form runs a host-side root-find (``brentq``), so
    sweeps run f64 (default) or an explicitly-passed f32 ``dtype`` with
    in-envelope calibrations.

    Returns a :class:`SolveResult` whose fields carry a leading sweep
    axis, plus the stacked ``w_star`` as ``result.x``'s exp when
    ``space="log"`` — as ``(w_star, result, grids_stacked)``.
    """
    import dataclasses as _dc

    import jax

    models = list(models)
    if not models:
        raise ValueError("empty sweep")
    fam = type(models[0])
    if any(type(m) is not fam for m in models):
        raise ValueError("one sweep = one model family; got mixed types")
    if space not in ("w", "log"):
        raise ValueError(f"unknown space {space!r}")
    is_ssy = isinstance(models[0], SSY)
    if is_ssy:
        from .operators.continuous_ssy import _factored_T as _fT
        builder = build_grid_ssy
    else:
        from .operators.continuous_gcy import _factored_T as _fT
        builder = build_grid_gcy
    gdtype = dtype or jnp.float64
    if len(grid_sizes) != (4 if is_ssy else 6):
        raise ValueError(f"grid_sizes must have {4 if is_ssy else 6} "
                         "entries for this family")
    # Per-calibration grids (bounds depend on the parameters), stacked
    # with a leading sweep axis; the vmapped body sees its own grids.
    grids_list = [builder(m, *grid_sizes, num_std_devs=num_std_devs,
                          dtype=gdtype) for m in models]
    grids_stacked = tuple(jnp.stack([g[d] for g in grids_list])
                          for d in range(len(grid_sizes)))
    fields = [f.name for f in _dc.fields(fam)]
    params = {name: jnp.asarray([getattr(m, name) for m in models],
                                gdtype) for name in fields}
    S = len(models)
    shape = tuple(int(s) for s in grid_sizes)
    if w_init is None:
        w0 = jnp.full((S,) + shape, DEFAULT_INIT_W, gdtype)
    else:
        w0 = jnp.asarray(w_init, gdtype)
        if w0.shape == shape:
            w0 = jnp.broadcast_to(w0[None], (S,) + shape)
        elif w0.shape != (S,) + shape:
            raise ValueError(f"w_init shape {w0.shape} matches neither "
                             f"{shape} nor {(S,) + shape}")
    x0 = jnp.log(w0) if space == "log" else w0

    def one(pvec, grids, x0_m):
        m = fam(**{k: pvec[k] for k in fields})
        T = _fT(m, grids, quad_degree, space, gdtype, None)
        return solve(T, x0_m, method=algorithm, tol=tol, jit=False,
                     **solver_opts)

    res = jax.jit(jax.vmap(one))(params, grids_stacked, x0)
    w_star = jnp.exp(res.x) if space == "log" else res.x
    return w_star, res, grids_stacked


# Fields that enter the discrete Koopmans operator only through the
# factor construction (theta, kappa) — differentiable with the
# discretization held fixed.  Dynamics fields (rho_*, s_*, phi_*) shape
# the Rouwenhorst chains themselves (host-side setup) and need the
# continuous path, whose operator construction is traceable end to end.
_PREFERENCE_FIELDS = frozenset({"beta", "gamma", "psi", "mu_c"})


def wc_ratio_differentiable(model,
                            grid_sizes: Sequence[int],
                            *,
                            fields: Sequence[str] = ("beta", "gamma", "psi"),
                            kind: str = "continuous",
                            quad_degree: int = 5,
                            space: str = "log",
                            num_std_devs: float = 3.2,
                            dtype=None,
                            algorithm: str = "newton",
                            tol: float = 1e-7,
                            w_init=None,
                            adjoint_rtol: float = 1e-8,
                            adjoint_maxiter: int = 200,
                            **solver_opts):
    """Build a *differentiable* calibration map ``p -> w*(p)``.

    Returns ``(wc_fn, p0)``: ``p0`` is a dict of the base model's values
    for the named ``fields`` (as jnp scalars), and ``wc_fn(p)`` solves the
    model with those field values substituted and returns the
    W/C ratio field in level space — differentiable in ``p`` through the
    implicit function theorem (:func:`solvers.implicit_fixed_point`), so

        ``jax.grad(lambda p: loss(wc_fn(p)))(p0)``

    prices a calibration gradient at one fixed-point solve plus one
    adjoint Krylov solve, regardless of iteration count.  The reference
    offers nothing comparable — its notebooks re-solve per calibration by
    hand (``code/ssy/continuous_junnan/ssy_test_continuous.md``).

    ``kind="continuous"`` (default) covers the factored quadrature
    ``interp="pre"`` chain — the operator construction that is
    jnp-traceable end to end over model parameters — with grids and
    quadrature nodes FIXED at the base calibration (the sensitivity is of
    collocation values; see the implicit module's docstring), no
    ``baseline`` fold, f64 by default; any model field differentiates.
    ``kind="discrete"`` differentiates through the factored discrete
    operator with the Rouwenhorst discretization held fixed, which is
    exact for the *preference* fields (beta, gamma, psi, mu_c) — dynamics
    fields are rejected there since they reshape the chains themselves.
    """
    import dataclasses as _dc

    from .solvers.implicit import implicit_fixed_point

    fam = type(model)
    is_ssy = isinstance(model, SSY)
    valid = {f.name for f in _dc.fields(fam)}
    bad = [f for f in fields if f not in valid]
    if bad:
        raise ValueError(f"unknown model fields {bad}; valid: {sorted(valid)}")
    if space not in ("w", "log"):
        raise ValueError(f"unknown space {space!r}")
    if kind not in ("continuous", "discrete"):
        raise ValueError(f"unknown kind {kind!r}")
    gdtype = dtype or jnp.float64
    if len(grid_sizes) != (4 if is_ssy else 6):
        raise ValueError(f"grid_sizes must have {4 if is_ssy else 6} "
                         "entries for this family")
    shape = tuple(int(s) for s in grid_sizes)
    w0 = (jnp.full(shape, DEFAULT_INIT_W, gdtype) if w_init is None
          else jnp.asarray(w_init, gdtype).reshape(shape))
    x0 = jnp.log(w0) if space == "log" else w0

    if kind == "discrete":
        non_pref = [f for f in fields if f not in _PREFERENCE_FIELDS]
        if non_pref:
            raise ValueError(
                f"kind='discrete' holds the Rouwenhorst discretization "
                f"fixed, so only preference fields "
                f"{sorted(_PREFERENCE_FIELDS & valid)} differentiate "
                f"exactly; {non_pref} shape the chains themselves — use "
                f"kind='continuous' for dynamics-field gradients")
        if is_ssy:
            disc = discretize_ssy(model, shape)
            factory = T_ssy_factory
        else:
            disc = discretize_gcy(model, shape)
            factory = T_gcy_factory

        def T_of_p(p, x):
            m = _dc.replace(model, **{k: p[k] for k in fields})
            return factory(m, disc, space=space, dtype=gdtype, jit=False)(x)
    else:
        if is_ssy:
            from .operators.continuous_ssy import _factored_T as _fT
            builder = build_grid_ssy
        else:
            from .operators.continuous_gcy import _factored_T as _fT
            builder = build_grid_gcy
        grids = builder(model, *grid_sizes, num_std_devs=num_std_devs,
                        dtype=gdtype)

        def T_of_p(p, x):
            m = _dc.replace(model, **{k: p[k] for k in fields})
            return _fT(m, grids, quad_degree, space, gdtype, None)(x)

    def wc_fn(p):
        x_star = implicit_fixed_point(
            T_of_p, p, x0, method=algorithm, tol=tol,
            adjoint_rtol=adjoint_rtol, adjoint_maxiter=adjoint_maxiter,
            **solver_opts)
        return jnp.exp(x_star) if space == "log" else x_star

    # The grids the returned field is collocated on (continuous kind);
    # downstream moment pipelines must interpolate on THESE, not rebuild
    # their own (calibrate.py).  None for the discrete kind.
    wc_fn.grids = grids if kind == "continuous" else None
    p0 = {f: jnp.asarray(getattr(model, f), gdtype) for f in fields}
    return wc_fn, p0


def prolong_w(w_coarse, grids_coarse, grids_fine):
    """Prolongate a solved w field from coarse grids to finer grids by
    multilinear interpolation (in log space, preserving positivity).

    The workhorse of grid continuation: beta ~ 1 makes cold starts pay
    thousands of contraction-rate iterations to move the *level*; a
    coarse solve captures the level for the cost of a tiny grid, and the
    fine solve then runs a few Newton steps on the shape.
    """
    from .ops.grids import flatten_mesh
    from .ops.interp import lin_interp

    x_fine = flatten_mesh(grids_fine).T                 # (dim, N_fine)
    ell_c = jnp.log(jnp.asarray(w_coarse))
    ell_f = lin_interp(x_fine, ell_c, grids_coarse)
    shape = tuple(len(g) for g in grids_fine)
    return jnp.exp(ell_f).reshape(shape)


def wc_ratio_continuation(model,
                          grid_schedule: Sequence[Sequence[int]],
                          *,
                          algorithm: str = "newton",
                          tol: float = 1e-7,
                          coarse_tol: Optional[float] = None,
                          **kwargs) -> WCSolution:
    """Continuation solve over a schedule of grid sizes.

    Solves the continuous model on ``grid_schedule[0]``, prolongates each
    solution as the next level's warm start, and returns the finest-level
    :class:`WCSolution`.  ``coarse_tol`` (default 100x looser than tol)
    applies to every level but the last.
    """
    if not grid_schedule:
        raise ValueError("empty grid schedule")
    coarse_tol = coarse_tol if coarse_tol is not None else min(1e-4, tol * 100)
    sol = None
    for level, sizes in enumerate(grid_schedule):
        last = level == len(grid_schedule) - 1
        w_init = None
        if sol is not None:
            from .ops.grids import (build_grid_gcy, build_grid_ssy)
            builder = build_grid_ssy if isinstance(model, SSY) else build_grid_gcy
            grids_fine = builder(model, *sizes,
                                 num_std_devs=kwargs.get("num_std_devs", 3.2),
                                 dtype=kwargs.get("dtype") or jnp.float64)
            w_init = prolong_w(sol.w_star, sol.grids, grids_fine)
        sol = wc_ratio_continuous(
            model, sizes, algorithm=algorithm,
            tol=tol if last else coarse_tol, w_init=w_init, **kwargs)
    return sol


def _coarse_additive_baseline(model, grid_sizes, *, num_std_devs,
                              quad_degree, dtype, coarse_size: int = 5,
                              coarse_tol: float = 1e-9):
    """Solve a small float64 model and fit an additive baseline on the
    target grids (profiles interpolated axis-by-axis)."""
    import numpy as np

    from .operators.continuous_common import additive_profiles
    from .ops.grids import build_grid_gcy, build_grid_ssy

    builder = build_grid_ssy if isinstance(model, SSY) else build_grid_gcy
    coarse_sizes = tuple(min(int(s), coarse_size) for s in grid_sizes)
    sol = wc_ratio_continuous(model, coarse_sizes, algorithm="newton",
                              tol=coarse_tol, interp="pre", space="log",
                              quad_degree=quad_degree,
                              num_std_devs=num_std_devs)
    const, profiles = additive_profiles(jnp.log(sol.w_star))
    fine_grids = builder(model, *grid_sizes, num_std_devs=num_std_devs,
                         dtype=dtype)
    profs = [np.interp(np.asarray(fg, np.float64),
                       np.asarray(cg, np.float64), p)
             for fg, cg, p in zip(fine_grids, sol.grids, profiles)]
    return const, profs


# ---------------------------------------------------------------------------
# de Groot alternative specification (companion paper temp.tex:1421-1516)

@dataclasses.dataclass
class DeGrootSolution:
    """Fixed point g* = (V/C)^(1-gamma) of the de Groot aggregator.

    ``log_g_star`` is the canonical storage: theta enters T~ as an
    *outer* power, so g* scales like (O(1))^theta — at the GCY
    calibration (theta ~ -36, h = 1) it lives at e^97..e^124, and wider
    grids can leave float range entirely.  ``g_star`` materializes
    exp(log g*) on demand (docs/math.md §9).
    """
    log_g_star: jnp.ndarray
    grids: Optional[Tuple[jnp.ndarray, ...]]
    result: SolveResult
    space: str

    @property
    def converged(self) -> bool:
        return bool(self.result.converged)

    @property
    def g_star(self) -> jnp.ndarray:
        return jnp.exp(self.log_g_star)


def degroot_fixed_point(model,
                        sizes: Sequence[int],
                        *,
                        kind: str = "discrete",
                        h=None,
                        algorithm: str = "newton",
                        tol: float = 1e-10,
                        space: Optional[str] = None,
                        quad_degree: int = 5,
                        num_std_devs: float = 3.2,
                        discretization: str = "rouwenhorst",
                        g_init_w: float = DEFAULT_INIT_W,
                        sa_warm_tol: float = 1e-6,
                        sa_warm_maxiter: int = 20000,
                        checkpoint_path: Optional[str] = None,
                        **solver_opts) -> DeGrootSolution:
    """End-to-end solve of the de Groot alternative specification.

    Mirrors ``wc_ratio_discrete`` / ``wc_ratio_continuous`` for the
    companion paper's state-dependent-discount family
    (``temp.tex:1421-1516``): build the untilted chain on the
    discretized (``kind="discrete"``) or continuous-quadrature
    (``kind="continuous"``) tier, then solve T~g = g.

    The log space is the default and the supported tier at production
    calibrations (see :class:`DeGrootSolution`); ``algorithm="newton"``
    there runs the validated two-stage recipe — SA to ``sa_warm_tol``
    (the outer map is severely stiff in theta, so cold-start Newton can
    safeguard-stall), then Newton to ``tol``.  ``space="w"`` solves in
    g directly (small-theta / cross-check tier; absolute tolerances only
    make sense when g* is O(1)-scaled, e.g. with a discount margin h<1).

    The initial guess maps the reference's standard w_init = 800 through
    the closed form g = ((1-beta) w)^theta (docs/math.md §9).
    """
    from .operators.degroot import (T_degroot_continuous_factory,
                                    T_degroot_factory)

    space = space or _auto_space()
    theta, beta = model.theta, model.beta
    if kind == "discrete":
        disc = (discretize_ssy if isinstance(model, SSY)
                else discretize_gcy)(model, tuple(sizes),
                                     method=discretization)
        T = T_degroot_factory(model, disc, h=h, space=space)
        grids = None
        shapes = disc.shapes
    elif kind == "continuous":
        builder = build_grid_ssy if isinstance(model, SSY) else build_grid_gcy
        grids = builder(model, *sizes, num_std_devs=num_std_devs)
        T = T_degroot_continuous_factory(model, grids, h=h,
                                         quad_degree=quad_degree,
                                         space=space)
        shapes = tuple(int(len(g)) for g in grids)
    else:
        raise ValueError(f"kind must be 'discrete' or 'continuous', "
                         f"got {kind!r}")

    ell0 = jnp.full(shapes, float(theta) * float(np.log((1.0 - beta)
                                                        * g_init_w)))
    if space == "log":
        x0 = ell0
        if algorithm == "newton":
            pre = solve(T, x0, method="successive_approx", tol=sa_warm_tol,
                        max_iter=sa_warm_maxiter)
            x0 = pre.x
        res = solve(T, x0, method=algorithm, tol=tol, **solver_opts)
        sol = DeGrootSolution(log_g_star=res.x, grids=grids, result=res,
                              space=space)
    else:
        res = solve(T, jnp.exp(ell0), method=algorithm, tol=tol,
                    **solver_opts)
        sol = DeGrootSolution(log_g_star=jnp.log(res.x), grids=grids,
                              result=res, space=space)
    if checkpoint_path:
        # Stored field is ln g* (scale-safe); spec/field markers in meta
        # keep the checkpoint self-describing next to w* checkpoints.
        save_solution(checkpoint_path, model, grids or (), sol.log_g_star,
                      meta=dict(spec="degroot", field="log_g", kind=kind,
                                shapes=list(shapes), algorithm=algorithm,
                                tol=tol, space=space,
                                h=(None if h is None
                                   else np.asarray(h).tolist()),
                                iterations=int(res.iterations),
                                residual=float(res.residual)))
    return sol
