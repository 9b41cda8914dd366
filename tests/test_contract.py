"""``ops/contract.lse_matmul``: row normalization, the deep windows of the
float32 path (``deep_window``/``deep_passes``) and their custom JVP.

The discrete SSY and GCY operators call it with ``deep_window=80,
deep_passes=3`` on the float32 path; the oracle is the exact log-sum-exp,
or an identity ``M`` under which the contraction returns its input.
"""

import jax
import jax.numpy as jnp
import numpy as np

from sdfs_via_autodiff_tpu.ops.contract import lse_matmul


def test_lse_matmul_row_normalization_is_exact():
    # lse_matmul row-normalizes M internally (log rowsum added to the
    # output): scaling any row of M by a huge factor must shift the
    # result by exactly log(scale) and change nothing else.
    rng = np.random.default_rng(3)
    M = jnp.asarray(rng.uniform(0.1, 1.0, (5, 6)))
    v = jnp.asarray(rng.standard_normal((4, 6)))
    base = lse_matmul(M, v, "om,km->ko", 1)
    scaled = lse_matmul(M.at[2].mul(1e80), v, "om,km->ko", 1)
    np.testing.assert_allclose(np.asarray(scaled[:, 2]),
                               np.asarray(base[:, 2]) + np.log(1e80),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(scaled[:, [0, 1, 3, 4]]),
                               np.asarray(base[:, [0, 1, 3, 4]]),
                               rtol=1e-12)


def test_lse_matmul_deep_window_recovers_localized_rows():
    # Localized rows over a 150-decade f32 span (the wide-Rouwenhorst
    # class): row o's whole mass sits below the joint shift's ~87-decade
    # window, so pass 1 underflows to log(0) = -inf; the deep_window
    # second pass recovers the true finite value.
    n = 8
    v = jnp.asarray(np.linspace(-150.0, 0.0, n),
                    jnp.float32).reshape(1, n)
    M = jnp.asarray(np.eye(n), jnp.float32)
    out0 = lse_matmul(M, v, "om,km->ko", 1)
    assert not bool(jnp.isfinite(out0).all())          # the failure mode
    out = lse_matmul(M, v, "om,km->ko", 1, deep_window=80.0)
    np.testing.assert_allclose(np.asarray(out), np.asarray(v), atol=1e-5)
    # f64 input: the deep window is a no-op and stays exact.
    out64 = lse_matmul(jnp.asarray(np.eye(n)),
                       jnp.asarray(np.asarray(v), jnp.float64),
                       "om,km->ko", 1, deep_window=80.0)
    np.testing.assert_allclose(np.asarray(out64), np.asarray(v, np.float64),
                               atol=1e-12)


def test_lse_matmul_deep_window_custom_jvp_matches_plain():
    # The deep path carries a custom JVP (one tangent einsum through the
    # deep window; naive autodiff of the two-pass primal doubles Newton's
    # inner-matvec memory): its jvp/vjp must agree with the single-window
    # autodiff wherever pass 1 doesn't underflow, and stay finite where
    # it does.
    rng = np.random.default_rng(7)
    M = jnp.asarray(rng.uniform(0.1, 1.0, (5, 6)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((4, 6)) * 3, jnp.float32)
    dv = jnp.asarray(rng.standard_normal((4, 6)), jnp.float32)
    dM = jnp.asarray(rng.standard_normal((5, 6)), jnp.float32) * 0.01
    f = lambda M, v: lse_matmul(M, v, "om,km->ko", 1, deep_window=80.0)
    f0 = lambda M, v: lse_matmul(M, v, "om,km->ko", 1)
    out, t = jax.jvp(f, (M, v), (dM, dv))
    out0, t0 = jax.jvp(f0, (M, v), (dM, dv))
    np.testing.assert_allclose(np.asarray(out), np.asarray(out0), atol=1e-6)
    np.testing.assert_allclose(np.asarray(t), np.asarray(t0), atol=1e-5)
    g = jax.grad(lambda v: jnp.sum(jnp.sin(f(M, v))))(v)
    g0 = jax.grad(lambda v: jnp.sum(jnp.sin(f0(M, v))))(v)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g0), atol=1e-5)
    # Localized rows (pass-1 underflow): tangent finite and correct —
    # identity M makes out = v, so d out/d v = 1 everywhere.
    n = 8
    vloc = jnp.asarray(np.linspace(-150.0, 0.0, n),
                       jnp.float32).reshape(1, n)
    Me = jnp.asarray(np.eye(n), jnp.float32)
    outl, tl = jax.jvp(
        lambda v: lse_matmul(Me, v, "om,km->ko", 1, deep_window=80.0),
        (vloc,), (jnp.ones_like(vloc),))
    np.testing.assert_allclose(np.asarray(outl), np.asarray(vloc),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(tl), 1.0, atol=1e-5)


def test_lse_matmul_three_window_tangent_covers_ultra_deep_rows():
    # Rows 167-247 nats below the slice max are reachable only by the
    # three-window primal; a single-window tangent zeroes them, and
    # Newton on a wide-Rouwenhorst SSY grid then treats those rows as
    # plain successive-approximation steps and stalls.  The multi-window
    # JVP must give the exact softmax derivative (= 1.0 against an
    # identity M) at every depth the primal covers.
    n = 10
    depths = np.linspace(-240.0, 0.0, n)       # spans all three windows
    vloc = jnp.asarray(depths, jnp.float32).reshape(1, n)
    Me = jnp.asarray(np.eye(n), jnp.float32)
    f = lambda v: lse_matmul(Me, v, "om,km->ko", 1,
                             deep_window=80.0, deep_passes=3)
    out, t = jax.jvp(f, (vloc,), (jnp.ones_like(vloc),))
    np.testing.assert_allclose(np.asarray(out), np.asarray(vloc), atol=1e-4)
    np.testing.assert_allclose(np.asarray(t), 1.0, atol=1e-5)
    # Mixed rows (non-identity M): tangent agrees with f64 autodiff of
    # the exact log-sum-exp at every covered depth.
    rng = np.random.default_rng(3)
    M = np.zeros((4, n))
    M[0, :3] = rng.uniform(0.5, 1.0, 3)         # shallow row
    M[1, 4:6] = rng.uniform(0.5, 1.0, 2)        # ~107-133 nat row
    M[2, 6:8] = rng.uniform(0.5, 1.0, 2)        # ~53-80: shallow
    M[3, :2] = rng.uniform(0.5, 1.0, 2)         # ~187-213: window 3
    Mf = jnp.asarray(M, jnp.float32)
    dv = jnp.asarray(rng.standard_normal((1, n)), jnp.float32)
    _, t32 = jax.jvp(
        lambda v: lse_matmul(Mf, v, "om,km->ko", 1,
                             deep_window=80.0, deep_passes=3),
        (vloc,), (dv,))

    def exact64(v):
        with np.errstate(divide="ignore"):
            logM = jnp.asarray(np.log(M))
        t = logM[None, :, :] + v[:, None, :]        # (k, o, m)
        m = jnp.max(t, axis=-1, keepdims=True)
        return m[..., 0] + jnp.log(jnp.sum(jnp.exp(t - m), axis=-1))

    _, t64 = jax.jvp(exact64, (jnp.asarray(depths).reshape(1, n),),
                     (jnp.asarray(np.asarray(dv), jnp.float64),))
    np.testing.assert_allclose(np.asarray(t32), np.asarray(t64),
                               rtol=2e-4, atol=2e-5)


def test_lse_matmul_deep_window_subnormal_band_full_precision():
    # Depths in (87.3, 103.2] nats land pass 1's contraction in the f32
    # SUBNORMAL range: "u > 0" passes, but log(u) then quantizes in
    # ~0.01-0.1-nat steps (1-2 mantissa bits), enough noise per
    # application to stall Newton and Anderson near residual 0.1.  The
    # selection floor must be the smallest NORMAL f32 so these rows ride
    # the deep window at full precision.
    depths = np.linspace(-102.0, -88.0, 8)     # the subnormal band
    n = len(depths) + 1
    v = jnp.asarray(np.append(depths, 0.0), jnp.float32).reshape(1, n)
    M = jnp.asarray(np.eye(n), jnp.float32)
    out = lse_matmul(M, v, "om,km->ko", 1, deep_window=80.0,
                     deep_passes=3)
    np.testing.assert_allclose(np.asarray(out)[0], np.asarray(v)[0],
                               atol=2e-5)
    # And the tangent in the same band is the exact softmax derivative
    # (1.0 against identity M), not subnormal-ratio noise.
    _, t = jax.jvp(
        lambda vv: lse_matmul(M, vv, "om,km->ko", 1, deep_window=80.0,
                              deep_passes=3),
        (v,), (jnp.ones_like(v),))
    np.testing.assert_allclose(np.asarray(t), 1.0, atol=1e-5)
