"""Node-chain reformulation of the post-power interpolation operators.

The reference's continuous operator semantics interpolate w *first* and
apply the theta-power afterwards (``interp="post"``, reference
``code/ssy/continuous_junnan/ssy_wc_ratio_continuous.py:111,146``; the
log-interpolation experiment ``test_newton.md:69-154`` is ``"loglin"``).
The power between interpolation and expectation blocks the per-axis
*expectation-matrix* factorization used by the "pre" path
(:mod:`.continuous_common`), so the reference — and round 1 of this
framework — evaluates these semantics pointwise: a 2^d-corner gather of w
per (state, node) pair, a bandwidth-bound memory pattern.

Reformulation implemented here: multilinear interpolation at a
*fixed* shock node eta_q is a linear map of the field, and because each
state dimension's successor is driven by its own component of eta_q, that
map factorizes per axis,

    interp(g)(x'(x, eta_q)) = [B_1[q] x B_2[q] x B_3[q] x B_4[q]] g,

with B_d[q][i, k] = b_k(mu_d(x_i) + sigma_d(x) * eta_q[d]) the hat-basis
matrix of axis d at node q (the z-axis matrix carries the h_z conditioning
of sigma_z, exactly like the discrete operator's z factor).  One operator
application is then a *loop over nodes of per-axis matmul chains* with a
running log-sum-exp accumulation across nodes — matmul contractions
instead of gathers, identical per-node structure to the factored discrete
operator.  The formulation is exact (same corner weights as the gather,
reordered), and works for tensor-product quadrature *and* joint Monte
Carlo draws (each draw is a node).

Per-node-chunk layout (the round-4 MC speedup): each scan step runs the
per-axis contractions as explicit ``lax.dot_general`` batched matmuls
with the node chunk (and any conditioning axes) as LEADING batch dims and
the contracted axis adjacent — einsum's planner turned the conditioned
contractions (``"sijbJ,slkiyJb->slkiyjb"``) into transpose-heavy
broadcast-reduce programs, which made the 2000-draw GCY Monte Carlo
operator far slower than its FLOP count.  One explicit (c, N)-intermediate
permute per step replaces the planner's materializations.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .continuous_common import hat_basis

__all__ = ["node_basis_ssy", "make_node_chain_T_ssy", "ssy_quadrature_nodes",
           "node_basis_gcy", "make_node_chain_T_gcy", "gcy_quadrature_nodes"]


def ssy_quadrature_nodes(quad_degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """Joint tensor-product Gauss-Hermite nodes (4, d^4) and log-weights
    (d^4,) in the (h_lam, h_c, h_z, z) shock order."""
    from ..ops.quadrature import tensor_quadrature_normal
    nodes, weights = tensor_quadrature_normal([quad_degree] * 4)
    return np.asarray(nodes, np.float64), np.log(np.asarray(weights,
                                                            np.float64))


def node_basis_ssy(model, grids: Sequence, nodes: np.ndarray) -> dict:
    """Per-node hat-basis matrices for the SSY successor maps.

    ``nodes`` is (4, Q) joint shocks.  Returns float64 host arrays:

    * ``B_lam`` (Q, n_l, n_l): h_lam' = rho_lam*h_lam + s_lam*eta1
    * ``B_c``   (Q, n_k, n_k): h_c'   = rho_c*h_c + s_c*eta2
    * ``B_hz``  (Q, n_i, n_i): h_z'   = rho_z*h_z + s_z*eta3
    * ``B_z``   (Q, n_i, n_j, n_j): z' = rho*z + phi_z*e^{h_z}*eta4,
      conditioned on the *current* h_z index i
    * ``pay``   (Q, n_l): theta * h_lam' — the exp(theta*h_lam') payoff of
      the H kernel (reference ``ssy_wc_ratio_continuous.py:110-114``) in
      log form.

    Dynamics parity: reference ``next_state`` (:63-83).
    """
    m = model
    hb = lambda g, pts: np.asarray(
        hat_basis(jnp.asarray(g, jnp.float64), jnp.asarray(pts, jnp.float64)),
        np.float64)
    h_lam, h_c, h_z, z = (np.asarray(g, np.float64) for g in grids)
    eta = np.asarray(nodes, np.float64)            # (4, Q)
    nl1 = m.rho_lam * h_lam[None, :] + m.s_lam * eta[0][:, None]   # (Q, n_l)
    B_lam = hb(h_lam, nl1)
    B_c = hb(h_c, m.rho_c * h_c[None, :] + m.s_c * eta[1][:, None])
    B_hz = hb(h_z, m.rho_z * h_z[None, :] + m.s_z * eta[2][:, None])
    sigma_z = m.phi_z * np.exp(h_z)                                # (n_i,)
    zn = (m.rho * z[None, None, :]
          + sigma_z[None, :, None] * eta[3][:, None, None])        # (Q, i, j)
    B_z = hb(z, zn)
    pay = m.theta * nl1
    return dict(B_lam=B_lam, B_c=B_c, B_hz=B_hz, B_z=B_z, pay=pay)


def _log_kappa_parts_ssy(model, grids):
    """log kappa(h_c, z) = log_A2[k] + log_A3[j] (reference
    ``ssy_wc_ratio_continuous.py:102-103``)."""
    m = model
    h_c, z = np.asarray(grids[1], np.float64), np.asarray(grids[3], np.float64)
    sigma_c = m.phi_c * np.exp(h_c)
    log_A2 = 0.5 * (1 - m.gamma) ** 2 * sigma_c ** 2
    log_A3 = (1 - m.gamma) * (m.mu_c + z)
    return log_A2, log_A3


def _pad_chunk(arrs, logw, chunk):
    """Pad the node axis to a multiple of ``chunk``.  Padding nodes reuse
    the first node's basis rows (finite values) with log-weight -inf, so
    they contribute exp(-inf) = 0 to the accumulation."""
    Q = logw.shape[0]
    pad = (-Q) % chunk
    if pad == 0:
        return arrs, logw
    arrs = [np.concatenate([a, np.repeat(a[:1], pad, axis=0)]) for a in arrs]
    logw = np.concatenate([logw, np.full(pad, -np.inf)])
    return arrs, logw


def make_node_chain_T_ssy(model, grids: Sequence, nodes: np.ndarray,
                          log_weights: np.ndarray, interp: str = "post",
                          dtype=None, chunk: Optional[int] = None,
                          precision=None) -> Callable:
    """Log-space post/loglin-interpolation SSY operator as a node chain.

    Maps ell = log w -> log T(w) with the reference's post-power semantics
    (``interp="post"``: E[interp(w)(x')^theta * e^{theta h_lam'}]) or the
    log-interpolation variant (``"loglin"``: interpolant applied to ell).
    Evaluated as a ``lax.scan`` over node chunks; each chunk runs the
    four per-axis basis contractions as batched einsums and folds into a
    running log-sum-exp (streaming max), so peak memory is
    O(chunk * N) regardless of the node count.  Covers tensor-product
    quadrature and joint Monte Carlo draws alike.
    """
    if interp not in ("post", "loglin"):
        raise ValueError(f"unknown interp {interp!r}")
    dtype = dtype or jnp.float64
    theta, beta = model.theta, model.beta
    shapes = tuple(len(g) for g in grids)
    basis = node_basis_ssy(model, grids, nodes)
    logw = np.asarray(log_weights, np.float64)
    Q = logw.shape[0]
    if chunk is None:
        chunk = min(Q, 32)
    arrs = [basis["B_lam"], basis["B_c"], basis["B_hz"], basis["B_z"],
            basis["pay"]]
    arrs, logw = _pad_chunk(arrs, logw, chunk)
    n_chunks = logw.shape[0] // chunk
    stack = lambda a: jnp.asarray(
        a.reshape((n_chunks, chunk) + a.shape[1:]), dtype)
    B1, B2, B3, B4, pay = map(stack, arrs)
    logw_d = jnp.asarray(logw.reshape(n_chunks, chunk), dtype)
    log_A2, log_A3 = _log_kappa_parts_ssy(model, grids)
    log_kappa = jnp.asarray(log_A2[:, None] + log_A3[None, :], dtype)
    theta_c = jnp.asarray(theta, dtype)
    if precision is None:
        precision = (jax.lax.Precision.HIGHEST if dtype == jnp.float32
                     else jax.lax.Precision.DEFAULT)
    dot = lambda a, b, dims: jax.lax.dot_general(a, b, dims,
                                                 precision=precision)
    neg_inf = jnp.asarray(-jnp.inf, dtype)
    from ..ops.accurate import accurate_exp, accurate_log, accurate_log1p
    n_l, n_k, n_i, n_j = shapes
    ck = chunk

    def chain(field2, xs):
        # field2: (L, K*I*J) — contracted-axis-leading 2-D view, shared
        # across all nodes.  Each step is one dot_general (batch dims
        # leading, contracted axis adjacent) plus one explicit permute of
        # the (chunk, N) intermediate; see the module docstring.
        b1, b2, b3, b4, _, _ = xs
        # L: (ck*l, L) @ (L, KIJ) — plain 2-D matmul, field read once.
        u = dot(b1.reshape(ck * n_l, n_l), field2,
                (((1,), (0,)), ((), ())))
        u = u.reshape(ck, n_l, n_k, n_i, n_j)
        # K: batch ck, contract K.
        u = jnp.transpose(u, (0, 2, 1, 3, 4)).reshape(
            ck, n_k, n_l * n_i * n_j)
        u = dot(b2, u, (((2,), (1,)), ((0,), (0,))))
        u = u.reshape(ck, n_k, n_l, n_i, n_j)
        # I: batch ck, contract I.
        u = jnp.transpose(u, (0, 3, 1, 2, 4)).reshape(
            ck, n_i, n_k * n_l * n_j)
        u = dot(b3, u, (((2,), (1,)), ((0,), (0,))))
        u = u.reshape(ck, n_i, n_k, n_l, n_j)
        # J: batch (ck, i) — the z factor is conditioned on current h_z.
        u = u.reshape(ck, n_i, n_k * n_l, n_j)
        u = dot(b4, u, (((3,), (3,)), ((0, 1), (0, 1))))
        u = u.reshape(ck, n_i, n_j, n_k, n_l)
        return jnp.transpose(u, (0, 4, 3, 1, 2))    # (ck, l, k, i, j)

    def T(ell):
        ell = ell.astype(dtype)
        if interp == "post":
            # The shift's gradient contribution cancels exactly (the chain
            # is linear and the log adds it back), so stop_gradient is
            # exact — and necessary: differentiating through max sets up
            # an argmax equality mask that XLA fusion can break (ulp
            # mismatch between the two fused recomputations -> 0/0).
            c = jax.lax.stop_gradient(jnp.max(ell))
            field = accurate_exp(ell - c)     # interp is linear: shift-safe
        else:
            c = jnp.asarray(0.0, dtype)
            field = ell
        field2 = field.reshape(n_l, n_k * n_i * n_j)

        def step(carry, xs):
            m, acc = carry
            u = chain(field2, xs)
            paych, logwch = xs[4], xs[5]
            if interp == "post":
                a = theta_c * (accurate_log(u) + c)
            else:
                a = theta_c * u
            a = (a + paych[:, :, None, None, None]
                 + logwch[:, None, None, None, None])
            # LSE shifts carry no gradient (shift-invariance); see above.
            m_s = jax.lax.stop_gradient(jnp.max(a, axis=0))
            m_new = jnp.maximum(m, m_s)
            # exp(m - m_new) with m = -inf on the first step: guard the
            # -inf - -inf = nan case.
            scale = jnp.where(m == neg_inf, 0.0, accurate_exp(m - m_new))
            acc = acc * scale + jnp.sum(accurate_exp(a - m_new[None]),
                                        axis=0)
            return (m_new, acc), None

        m0 = jnp.full(shapes, neg_inf, dtype)
        acc0 = jnp.zeros(shapes, dtype)
        (m, acc), _ = jax.lax.scan(step, (m0, acc0),
                                   (B1, B2, B3, B4, pay, logw_d))
        log_kg = m + accurate_log(acc) + log_kappa[None, :, None, :]
        return accurate_log1p(beta * accurate_exp(log_kg / theta_c))

    return T


def gcy_quadrature_nodes(quad_degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """Joint tensor-product Gauss-Hermite nodes (6, d^6) and log-weights
    in the (h_lam, h_c, h_z, h_zpi, z, z_pi) shock order.  Note d^6 nodes
    make quadrature node-chains O(d^6 * N) — Monte Carlo (a few thousand
    joint draws) is usually the cheaper expectation at 6 states."""
    from ..ops.quadrature import tensor_quadrature_normal
    nodes, weights = tensor_quadrature_normal([quad_degree] * 6)
    return np.asarray(nodes, np.float64), np.log(np.asarray(weights,
                                                            np.float64))


def node_basis_gcy(model, grids: Sequence, nodes: np.ndarray) -> dict:
    """Per-node hat-basis matrices for the GCY successor maps.

    ``nodes`` is (6, Q) joint shocks in the continuous-layer state order
    (h_lam, h_c, h_z, h_zpi, z, z_pi).  Returns float64 host arrays:
    own-axis ``B_lam``/``B_c``/``B_hz``/``B_hzpi`` (Q, n, n), the
    conditioned ``B_zpi`` (Q, n_y, n_b, n_b) (sigma_zpi depends on the
    current h_zpi index y) and ``B_z`` (Q, n_i, n_j, n_b, n_j) (mean
    depends on current z_pi = b, spread on current h_z = i), and ``pay``
    (Q, n_l) = theta * h_lam'.  Dynamics parity: reference
    ``gcy_wc_ratio_continuous.py:77-115``.
    """
    m = model
    hb = lambda g, pts: np.asarray(
        hat_basis(jnp.asarray(g, jnp.float64), jnp.asarray(pts, jnp.float64)),
        np.float64)
    h_lam, h_c, h_z, h_zpi, z, z_pi = (np.asarray(g, np.float64)
                                       for g in grids)
    eta = np.asarray(nodes, np.float64)            # (6, Q)
    nl1 = m.rho_lam * h_lam[None, :] + m.s_lam * eta[0][:, None]
    B_lam = hb(h_lam, nl1)
    B_c = hb(h_c, m.rho_c * h_c[None, :] + m.s_c * eta[1][:, None])
    B_hz = hb(h_z, m.rho_z * h_z[None, :] + m.s_z * eta[2][:, None])
    B_hzpi = hb(h_zpi, m.rho_zpi * h_zpi[None, :] + m.s_zpi * eta[3][:, None])
    sigma_z = m.phi_z * np.exp(h_z)                # (n_i,)
    sigma_zpi = m.phi_zpi * np.exp(h_zpi)          # (n_y,)
    zpin = (m.rho_pipi * z_pi[None, None, :]
            + sigma_zpi[None, :, None] * eta[5][:, None, None])  # (Q, y, b)
    B_zpi = hb(z_pi, zpin)
    zn = (m.rho * z[None, None, :, None] + m.rho_pi * z_pi[None, None, None, :]
          + sigma_z[None, :, None, None] * eta[4][:, None, None, None])
    B_z = hb(z, zn)                                # (Q, i, j, b, n_j)
    pay = m.theta * nl1
    return dict(B_lam=B_lam, B_c=B_c, B_hz=B_hz, B_hzpi=B_hzpi,
                B_zpi=B_zpi, B_z=B_z, pay=pay)


def make_node_chain_T_gcy(model, grids: Sequence, nodes: np.ndarray,
                          log_weights: np.ndarray, interp: str = "post",
                          dtype=None, chunk: Optional[int] = None,
                          precision=None) -> Callable:
    """Log-space post/loglin-interpolation GCY operator as a node chain
    (six-state analogue of :func:`make_node_chain_T_ssy`; field order
    (l, k, i, y, j, b) = (h_lam, h_c, h_z, h_zpi, z, z_pi)).

    Cost scales with the node count: Monte Carlo draws (reference default
    2000, ``gcy_wc_ratio_continuous.py``) are the practical expectation
    at 6 states — a d-degree tensor quadrature has d^6 joint nodes.
    """
    if interp not in ("post", "loglin"):
        raise ValueError(f"unknown interp {interp!r}")
    dtype = dtype or jnp.float64
    theta, beta = model.theta, model.beta
    shapes = tuple(len(g) for g in grids)
    basis = node_basis_gcy(model, grids, nodes)
    logw = np.asarray(log_weights, np.float64)
    Q = logw.shape[0]
    if chunk is None:
        chunk = min(Q, 16)
    arrs = [basis["B_lam"], basis["B_c"], basis["B_hz"], basis["B_hzpi"],
            basis["B_zpi"],
            # (Q, i, j, b, J) -> (Q, i, b, j, J): the chain's J step
            # batches over (node, i, b) with j as the lhs free dim.
            np.ascontiguousarray(basis["B_z"].transpose(0, 1, 3, 2, 4)),
            basis["pay"]]
    arrs, logw = _pad_chunk(arrs, logw, chunk)
    n_chunks = logw.shape[0] // chunk
    stack = lambda a: jnp.asarray(
        a.reshape((n_chunks, chunk) + a.shape[1:]), dtype)
    B1, B2, B3, B4, B5, B6, pay = map(stack, arrs)
    logw_d = jnp.asarray(logw.reshape(n_chunks, chunk), dtype)
    from .continuous_gcy import _log_kappa_gcy
    log_kappa = jnp.asarray(np.asarray(_log_kappa_gcy(
        model, np.asarray(grids[1], np.float64)[:, None],
        np.asarray(grids[4], np.float64)[None, :])), dtype)  # (k, j)
    theta_c = jnp.asarray(theta, dtype)
    if precision is None:
        precision = (jax.lax.Precision.HIGHEST if dtype == jnp.float32
                     else jax.lax.Precision.DEFAULT)
    dot = lambda a, b, dims: jax.lax.dot_general(a, b, dims,
                                                 precision=precision)
    neg_inf = jnp.asarray(-jnp.inf, dtype)
    from ..ops.accurate import accurate_exp, accurate_log, accurate_log1p
    n_l, n_k, n_i, n_y, n_j, n_b = shapes
    ck = chunk

    def chain(field2, xs):
        # field2: (L, K*I*Y*J*B) shared 2-D view; explicit dot_general
        # steps with leading batch dims (see the module docstring).
        b1, b2, b3, b4, b5, b6 = xs[:6]
        # L: (ck*l, L) @ (L, rest) — one plain matmul, field read once.
        u = dot(b1.reshape(ck * n_l, n_l), field2,
                (((1,), (0,)), ((), ())))
        u = u.reshape(ck, n_l, n_k, n_i, n_y, n_j, n_b)
        # K: batch ck, contract K.
        u = jnp.transpose(u, (0, 2, 1, 3, 4, 5, 6)).reshape(ck, n_k, -1)
        u = dot(b2, u, (((2,), (1,)), ((0,), (0,))))
        u = u.reshape(ck, n_k, n_l, n_i, n_y, n_j, n_b)
        # I (next h_z): batch ck, contract I.
        u = jnp.transpose(u, (0, 3, 1, 2, 4, 5, 6)).reshape(ck, n_i, -1)
        u = dot(b3, u, (((2,), (1,)), ((0,), (0,))))
        u = u.reshape(ck, n_i, n_k, n_l, n_y, n_j, n_b)
        # Y (next h_zpi): batch ck, contract Y.
        u = jnp.transpose(u, (0, 4, 1, 2, 3, 5, 6)).reshape(ck, n_y, -1)
        u = dot(b4, u, (((2,), (1,)), ((0,), (0,))))
        u = u.reshape(ck, n_y, n_i, n_k, n_l, n_j, n_b)
        # B (next z_pi; sigma_zpi conditioned on current y): batch (ck, y).
        u = u.reshape(ck, n_y, n_i * n_k * n_l * n_j, n_b)
        u = dot(b5, u, (((3,), (3,)), ((0, 1), (0, 1))))
        u = u.reshape(ck, n_y, n_b, n_i, n_k, n_l, n_j)
        # J (next z; mean/spread conditioned on current b, i):
        # batch (ck, i, b); b6 is host-pretransposed to (ck, i, b, j, J).
        u = jnp.transpose(u, (0, 3, 2, 1, 4, 5, 6)).reshape(
            ck, n_i, n_b, n_y * n_k * n_l, n_j)
        u = dot(b6, u, (((4,), (4,)), ((0, 1, 2), (0, 1, 2))))
        u = u.reshape(ck, n_i, n_b, n_j, n_y, n_k, n_l)
        return jnp.transpose(u, (0, 6, 5, 1, 4, 3, 2))  # (ck,l,k,i,y,j,b)

    def T(ell):
        ell = ell.astype(dtype)
        if interp == "post":
            # Shift gradients cancel exactly; see make_node_chain_T_ssy.
            c = jax.lax.stop_gradient(jnp.max(ell))
            field = accurate_exp(ell - c)
        else:
            c = jnp.asarray(0.0, dtype)
            field = ell
        field2 = field.reshape(n_l, n_k * n_i * n_y * n_j * n_b)

        def step(carry, xs):
            m, acc = carry
            u = chain(field2, xs)
            paych, logwch = xs[6], xs[7]
            if interp == "post":
                a = theta_c * (accurate_log(u) + c)
            else:
                a = theta_c * u
            a = (a + paych[:, :, None, None, None, None, None]
                 + logwch[:, None, None, None, None, None, None])
            m_s = jax.lax.stop_gradient(jnp.max(a, axis=0))
            m_new = jnp.maximum(m, m_s)
            scale = jnp.where(m == neg_inf, 0.0, accurate_exp(m - m_new))
            acc = acc * scale + jnp.sum(accurate_exp(a - m_new[None]),
                                        axis=0)
            return (m_new, acc), None

        m0 = jnp.full(shapes, neg_inf, dtype)
        acc0 = jnp.zeros(shapes, dtype)
        (m, acc), _ = jax.lax.scan(
            step, (m0, acc0), (B1, B2, B3, B4, B5, B6, pay, logw_d))
        log_kg = (m + accurate_log(acc)
                  + log_kappa[None, :, None, None, :, None])
        return accurate_log1p(beta * accurate_exp(log_kg / theta_c))

    return T
