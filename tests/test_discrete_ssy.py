"""Discrete SSY operator: oracle, dense-H, log-space, and end-to-end tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from sdfs_via_autodiff_tpu import (
    SSY, T_ssy_factory, dense_H_ssy, discretize_ssy, solve)
from oracles import T_ssy_oracle

SHAPES = (4, 3, 5, 6)


@pytest.fixture(scope="module")
def setup():
    model = SSY()
    disc = discretize_ssy(model, SHAPES)
    return model, disc


def test_factored_matches_loop_oracle(setup, rng):
    model, disc = setup
    T = T_ssy_factory(model, disc)
    w = jnp.asarray(np.exp(rng.standard_normal(SHAPES)))
    np.testing.assert_allclose(np.asarray(T(w)),
                               T_ssy_oracle(w, model, disc), rtol=1e-10)


def test_factored_matches_dense_H(setup, rng):
    model, disc = setup
    T = T_ssy_factory(model, disc)
    H = dense_H_ssy(model, disc)
    theta, beta = model.theta, model.beta
    w = jnp.asarray(np.exp(rng.standard_normal(SHAPES)))
    via_dense = 1 + beta * (H @ (w.reshape(-1) ** theta)) ** (1 / theta)
    np.testing.assert_allclose(np.asarray(T(w)).ravel(),
                               np.asarray(via_dense), rtol=1e-10)


def test_log_space_consistent(setup, rng):
    model, disc = setup
    T = T_ssy_factory(model, disc)
    T_log = T_ssy_factory(model, disc, space="log")
    w = jnp.asarray(np.exp(rng.standard_normal(SHAPES))) * 500
    np.testing.assert_allclose(np.exp(np.asarray(T_log(jnp.log(w)))),
                               np.asarray(T(w)), rtol=1e-12)


def test_operator_is_monotone(setup, rng):
    # T is order-preserving (Koopmans operators are monotone).
    model, disc = setup
    T = T_ssy_factory(model, disc)
    w = jnp.asarray(np.exp(rng.standard_normal(SHAPES))) + 1.0
    bigger = w + 0.5
    assert np.all(np.asarray(T(bigger)) >= np.asarray(T(w)) - 1e-12)


def test_spectral_condition(setup):
    # Existence/uniqueness requires r(H)^(1/theta) < 1 at the default
    # calibration (Stachurski–Zhang; SURVEY.md §0).
    model, disc = setup
    H = np.asarray(dense_H_ssy(model, disc))
    r = np.max(np.abs(np.linalg.eigvals(H)))
    assert model.beta * r ** (1 / model.theta) < 1


@pytest.mark.parametrize("method,kwargs", [
    ("successive_approx", {}),
    ("newton", {}),
    ("newton", {"inner": "dense"}),
    ("anderson", {}),
])
def test_end_to_end_solve(setup, method, kwargs):
    model, disc = setup
    T = T_ssy_factory(model, disc)
    w0 = jnp.full(SHAPES, 800.0)   # reference init, ssy_wc_ratio.py:233-234
    res = solve(T, w0, method=method, tol=1e-7, **kwargs)
    assert bool(res.converged), f"{method} did not converge: {res}"
    # Fixed point property, independent of solver path.
    np.testing.assert_allclose(np.asarray(T(res.x)), np.asarray(res.x),
                               atol=2e-7)


def test_solvers_agree(setup):
    model, disc = setup
    T = T_ssy_factory(model, disc)
    w0 = jnp.full(SHAPES, 800.0)
    w_succ = solve(T, w0, method="successive_approx", tol=1e-10).x
    w_newt = solve(T, w0, method="newton", tol=1e-10).x
    np.testing.assert_allclose(np.asarray(w_succ), np.asarray(w_newt),
                               atol=1e-7)


def test_log_space_solve_matches_w_space(setup):
    model, disc = setup
    T = T_ssy_factory(model, disc)
    T_log = T_ssy_factory(model, disc, space="log")
    w0 = jnp.full(SHAPES, 800.0)
    w_star = solve(T, w0, method="newton", tol=1e-10).x
    ell_star = solve(T_log, jnp.log(w0), method="newton", tol=1e-12).x
    np.testing.assert_allclose(np.exp(np.asarray(ell_star)),
                               np.asarray(w_star), atol=1e-6)


def test_reference_tuple_layout(setup):
    model, disc = setup
    arrays = disc.as_reference_tuple()
    assert len(arrays) == 10
    n_l, n_k, n_i, n_j = SHAPES
    assert arrays[6].shape == (n_i, n_j)           # z_states
    assert arrays[7].shape == (n_i, n_j, n_j)      # z_Q family
    np.testing.assert_allclose(np.asarray(arrays[7]).sum(-1), 1.0, rtol=1e-12)


def test_normalized_operator_matches_plain(setup, rng):
    # Baseline normalization is exact algebra: same operator values and
    # the same fixed point.
    model, disc = setup
    T_plain = T_ssy_factory(model, disc, space="log")
    T_norm = T_ssy_factory(model, disc, space="log", baseline="loglinear",
                           dtype=jnp.float64)
    ell = jnp.asarray(np.asarray(T_norm.baseline_log_w)
                      + 0.05 * rng.standard_normal(SHAPES))
    np.testing.assert_allclose(np.asarray(T_norm(ell)),
                               np.asarray(T_plain(ell)), atol=1e-11)
    res_n = solve(T_norm, T_norm.baseline_log_w, method="newton", tol=1e-11)
    res_p = solve(T_plain, jnp.full(SHAPES, jnp.log(800.0)), method="newton",
                  tol=1e-11)
    assert bool(res_n.converged)
    np.testing.assert_allclose(np.asarray(res_n.x), np.asarray(res_p.x),
                               atol=1e-9)


@pytest.mark.slow


def test_normalized_f32_wide_grid_stays_finite():
    # On wide Rouwenhorst grids a single state axis carries more log-range
    # than f32 exp can represent; the baseline-normalized operator stays
    # finite where the plain log-space operator overflows.
    model = SSY()
    disc32 = discretize_ssy(model, (4, 4, 4, 48), dtype=jnp.float32)
    T_norm = T_ssy_factory(model, disc32, space="log", baseline="loglinear",
                           dtype=jnp.float32)
    ell = T_norm.baseline_log_w
    for _ in range(30):
        ell = T_norm(ell)
    assert bool(jnp.all(jnp.isfinite(ell)))
    # Converges toward the f64 fixed point of the plain operator.
    disc64 = discretize_ssy(model, (4, 4, 4, 48))
    T64 = T_ssy_factory(model, disc64, space="log")
    ref = solve(T64, jnp.asarray(T_norm.baseline_log_w, jnp.float64),
                method="newton", tol=1e-11)
    res = solve(T_norm, ell, method="newton", tol=3e-5)
    assert bool(res.converged)
    rel = np.max(np.abs(np.exp(np.asarray(res.x, np.float64))
                        - np.exp(np.asarray(ref.x)))
                 / np.exp(np.asarray(ref.x)))
    assert rel < 1e-3


def test_normalized_f32_full_width_rouwenhorst_ladder():
    # z = 256 spans ±sqrt(255) sigma — the regime where (a) the folded
    # factors overflow a plain f32 cast of exp(logM) (round-5 fix:
    # construction-time log-domain row normalization) and (b) ladder-
    # corner rows sit further below their slice max than one ~87-nat
    # window (fix: lse_matmul deep_window).  North-star twin:
    # benchmarks/northstar.py ssy_discrete_rouwenhorst at (32,32,32,384).
    model = SSY()
    disc = discretize_ssy(model, (3, 3, 3, 256), dtype=jnp.float32)
    T32 = T_ssy_factory(model, disc, space="log", baseline="loglinear",
                        dtype=jnp.float32)
    x0 = jnp.asarray(T32.baseline_log_w, jnp.float32)
    y = T32(x0)
    assert bool(jnp.all(jnp.isfinite(y)))
    disc64 = discretize_ssy(model, (3, 3, 3, 256))
    T64 = T_ssy_factory(model, disc64, space="log", baseline="loglinear")
    y64 = T64(jnp.asarray(x0, jnp.float64))
    assert float(jnp.max(jnp.abs(jnp.asarray(y, jnp.float64) - y64))) < 1e-4


def test_existence_check_matches_dense_eig(setup):
    # Matrix-free power iteration vs dense eigenvalues on a small grid.
    from sdfs_via_autodiff_tpu.utils.spectral import existence_check
    model, disc = setup
    rep = existence_check(model, disc)
    H = np.asarray(dense_H_ssy(model, disc))
    r_dense = float(np.max(np.abs(np.linalg.eigvals(H))))
    np.testing.assert_allclose(rep.spectral_radius, r_dense, rtol=1e-7)
    assert rep.exists_unique           # default calibration satisfies it
    assert "exists_unique=True" in repr(rep)


@pytest.mark.slow


def test_discrete_polish_refines_f32_solve():
    # f32 fast solve -> f64 Newton polish, mirroring the continuous
    # driver's two-stage recipe (reference default tol 1e-7,
    # /root/reference/code/solvers.py:16).
    from sdfs_via_autodiff_tpu import wc_ratio_discrete
    model = SSY()
    shapes = (4, 4, 4, 6)
    sol = wc_ratio_discrete(model, shapes, algorithm="newton", tol=1e-9,
                            dtype=jnp.float32, polish=True)
    assert sol.converged
    ref = wc_ratio_discrete(model, shapes, algorithm="newton", tol=1e-10)
    np.testing.assert_allclose(np.asarray(sol.w_star),
                               np.asarray(ref.w_star), atol=1e-6)


@pytest.mark.slow


def test_discrete_polish_stage_placements():
    # polish is a flag: the float64 stage runs on the default device.
    # The old placement spellings ("host", "device") are refused.
    import pytest

    from sdfs_via_autodiff_tpu import wc_ratio_discrete
    model = SSY()
    shapes = (4, 4, 4, 6)
    sol = wc_ratio_discrete(model, shapes, algorithm="newton", tol=1e-9,
                            dtype=jnp.float32, polish=True)
    assert sol.converged
    assert float(sol.result.residual) < 1e-9
    assert sol.w_star.dtype == jnp.float64
    for stage in ("host", "device", "gpu"):
        with pytest.raises(ValueError, match="polish"):
            wc_ratio_discrete(model, shapes, tol=1e-9, polish=stage)


def test_fast_transcendentals_escape_hatch(setup, rng):
    # transcendentals="fast" (hardware exp/log in the XLA chain) agrees
    # with the accurate default to f32-hardware accuracy and is accepted
    # by the factory; default stays "accurate".
    model, disc = setup
    ell = jnp.asarray(rng.standard_normal(SHAPES) * 0.1 + np.log(800.0),
                      jnp.float32)
    T_acc = T_ssy_factory(model, disc, space="log", dtype=jnp.float32)
    T_fast = T_ssy_factory(model, disc, space="log", dtype=jnp.float32,
                           transcendentals="fast")
    a, f = np.asarray(T_acc(ell)), np.asarray(T_fast(ell))
    assert np.max(np.abs(a - f)) < 5e-3       # hardware-log error scale
    # "mixed" (hardware exp + accurate log — the strip/streamed kernels'
    # tier) is accepted by the XLA chain too, so engine-"auto" fallbacks
    # keep the option; it sits inside the fast tier's error envelope.
    T_mixed = T_ssy_factory(model, disc, space="log", dtype=jnp.float32,
                            transcendentals="mixed")
    m = np.asarray(T_mixed(ell))
    assert np.max(np.abs(a - m)) < 5e-3
    with pytest.raises(ValueError):
        T_ssy_factory(model, disc, space="log",
                      transcendentals="wrong")(ell)


def test_f32_envelope_warning_wide_rouwenhorst():
    # The NaN NORTHSTAR config (32,32,32,384)-class grids must warn
    # upfront from the two-phase operand builders (plain and normalized)
    # instead of NaN-ing after a full kernel run.  A narrow grid must not
    # warn.
    import warnings

    from sdfs_via_autodiff_tpu.operators.two_phase import (
        two_phase_operands_ssy)
    model = SSY()
    # Plain operands: theta * within-column-group log-w span ~ 129 > 85.
    wide = discretize_ssy(model, (4, 4, 32, 96))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        two_phase_operands_ssy(model, wide, baseline=None)
    assert any("exceeds float32" in str(w.message) for w in rec), \
        [str(w.message) for w in rec]
    # Normalized operands at the NaN NORTHSTAR z-width class: the folded
    # M3 factor reaches e^69 — headroom warning fires.
    very_wide = discretize_ssy(model, (4, 4, 32, 384))
    with warnings.catch_warnings(record=True) as rec3:
        warnings.simplefilter("always")
        two_phase_operands_ssy(model, very_wide, baseline="loglinear")
    assert any("headroom" in str(w.message) for w in rec3), \
        [str(w.message) for w in rec3]
    narrow = discretize_ssy(model, (4, 4, 4, 6))
    with warnings.catch_warnings(record=True) as rec2:
        warnings.simplefilter("always")
        two_phase_operands_ssy(model, narrow, baseline=None)
        two_phase_operands_ssy(model, narrow, baseline="loglinear")
    assert not [w for w in rec2 if "float32" in str(w.message)
                or "headroom" in str(w.message)]


def test_f32_tol_floor_is_theta_aware():
    from sdfs_via_autodiff_tpu.drivers import f32_tol_floor
    from sdfs_via_autodiff_tpu import GCY
    assert f32_tol_floor(SSY().theta) == pytest.approx(5e-6, rel=0.1)
    # GCY's theta = -36 floor is ~2-3e-5 (scale_demo stalled at 2.2e-5,
    # converges at 3e-5) — the fixed 5e-6 warning missed it.
    assert 2e-5 < f32_tol_floor(GCY().theta) < 4e-5
    assert f32_tol_floor(None) == 5e-6


def test_stability_decomposition_exact(setup):
    # Companion-paper decomposition S = ln beta + S_lambda + (1-1/psi) S_c
    # (paper/temp.tex:820-870): exact on the chain since H = B_lam (x) M_c.
    from sdfs_via_autodiff_tpu.utils.spectral import stability_decomposition
    model, disc = setup
    dec = stability_decomposition(model, disc)
    np.testing.assert_allclose(dec.S, dec.S_direct, atol=1e-8)
    assert dec.exists_unique
    assert dec.ln_beta < 0            # time preference always stabilizes
    np.testing.assert_allclose(dec.coefficient, 1 - 1 / model.psi)


@pytest.mark.slow
def test_stability_exponent_mc_triple_crosscheck():
    # On a damped calibration (tilted-sum std << 1, where naive MC of
    # exponential moments is consistent) three independent routes agree:
    # the chain-spectral decomposition, the paper's path-MC estimator
    # (temp.tex:2224-2270), and the analytic Gaussian long-run formula
    # S_lambda = (theta/2) s_lam^2 / (1 - rho_lam)^2.
    import dataclasses
    import math

    from sdfs_via_autodiff_tpu.utils.spectral import (
        stability_decomposition, stability_exponent_mc)

    m = dataclasses.replace(SSY(), s_lam=4e-5, s_z=math.sqrt(0.0039) / 10,
                            s_c=math.sqrt(0.0096) / 10, phi_z=1e-5)
    dec = stability_decomposition(m, discretize_ssy(m, (8, 8, 8, 12)))
    mc = stability_exponent_mc(m, T=10_000, N=2_000, seed=0)
    S_lam_exact = m.theta / 2 * m.s_lam**2 / (1 - m.rho_lam)**2
    np.testing.assert_allclose(dec.S_lambda, S_lam_exact, atol=1e-8)
    np.testing.assert_allclose(mc["S"], dec.S, atol=1e-5)
    np.testing.assert_allclose(mc["S_lambda"], S_lam_exact, atol=2e-6)


def test_stability_closed_forms_match_chain():
    # Companion-paper Applications closed forms (temp.tex:967-1138):
    # purely-transient (Prop p:ar1) and constant-volatility long-run
    # risk.  Cross-checked against the chain-spectral decomposition on
    # degenerate damped calibrations where the Rouwenhorst chain
    # converges to the Gaussian formulas.
    import dataclasses

    from sdfs_via_autodiff_tpu.utils.spectral import (
        stability_decomposition, stability_exponent_constant_vol,
        stability_exponent_transient)

    base = dict(s_lam=4e-5, rho_lam=SSY().rho_lam)

    # Purely transient: freeze h_c, h_z and kill z entirely.  The
    # consumption-channel tilt is then scalar on the chain, so S_c
    # matches EXACTLY; S_lambda converges at the damped calibration.
    m_tr = dataclasses.replace(SSY(), s_lam=4e-5, s_c=0.0, s_z=0.0,
                               phi_z=0.0)
    cf = stability_exponent_transient(beta=m_tr.beta, gamma=m_tr.gamma,
                                      psi=m_tr.psi, mu_c=m_tr.mu_c,
                                      sigma_c=m_tr.phi_c, **base)
    dec = stability_decomposition(m_tr, discretize_ssy(m_tr, (8, 1, 1, 1)))
    np.testing.assert_allclose(dec.S_c, cf.S_c, atol=1e-12)
    np.testing.assert_allclose(dec.S_lambda, cf.S_lambda, atol=1e-8)
    np.testing.assert_allclose(dec.S, cf.S, atol=1e-8)
    assert cf.exists_unique == dec.exists_unique

    # Constant-vol LRR: keep z as a damped constant-volatility AR(1)
    # (h_z frozen at 0 so sigma_z = phi_z).
    m_cv = dataclasses.replace(SSY(), s_lam=4e-5, s_c=0.0, s_z=0.0,
                               phi_z=2e-4, rho=0.9)
    cf_cv = stability_exponent_constant_vol(
        beta=m_cv.beta, gamma=m_cv.gamma, psi=m_cv.psi, mu_c=m_cv.mu_c,
        sigma_c=m_cv.phi_c, sigma=m_cv.phi_z, rho=m_cv.rho, **base)
    dec_cv = stability_decomposition(m_cv,
                                     discretize_ssy(m_cv, (8, 1, 1, 12)))
    np.testing.assert_allclose(dec_cv.S_c, cf_cv.S_c, atol=1e-7)
    np.testing.assert_allclose(dec_cv.S, cf_cv.S, atol=1e-7)

    # sigma -> 0 collapses constant-vol onto the transient formula.
    cf0 = stability_exponent_constant_vol(
        beta=m_tr.beta, gamma=m_tr.gamma, psi=m_tr.psi, mu_c=m_tr.mu_c,
        sigma_c=m_tr.phi_c, sigma=0.0, rho=0.5, **base)
    np.testing.assert_allclose(cf0.S, cf.S, rtol=1e-15)


def test_lse_matmul_all_neg_inf_slice_gives_neg_inf():
    # log of exact-zero mass must propagate as -inf, not NaN (the
    # solvers' NaN guards would abort a run that should converge).
    from sdfs_via_autodiff_tpu.ops.contract import lse_matmul

    M = jnp.asarray([[0.5, 0.5], [0.3, 0.7]])
    lv = jnp.full((2, 2), -jnp.inf)
    out = np.asarray(lse_matmul(M, lv, "ij,jk->ik", 0))
    assert np.all(np.isneginf(out))
    lv2 = jnp.asarray([[0.0, -jnp.inf], [-jnp.inf, -1.0]])
    out2 = np.asarray(lse_matmul(M, lv2, "ij,jk->ik", 0))
    np.testing.assert_allclose(
        out2, [[np.log(0.5), np.log(0.5) - 1.0],
               [np.log(0.3), np.log(0.7) - 1.0]], rtol=1e-12)
