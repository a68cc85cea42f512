"""Collapsed variational lower bound (Titsias 2009 / Titsias & Lawrence 2010).

Re-design of the reference's global bound assembly (GParML
``partial_terms.py`` ``get_global_statistics``/bound methods, SURVEY.md §2
[C-HIGH]): the O(M³) terms — Cholesky of K_MM, triangular solves, log-dets,
traces — computed from the psum-reduced sufficient statistics. Runs on every
device (replicated) under jit; XLA's linear algebra handles the factorizations.

With A = K_MM + beta * Psi2 (SURVEY.md Appendix A):

  F = -(ND/2) log 2pi + (ND/2) log beta + (D/2) log|K_MM| - (D/2) log|A|
      - (beta/2) sum_n y_n^T y_n - (beta D/2) psi0 + (beta D/2) tr(K_MM^-1 Psi2)
      + (beta^2/2) tr(A^-1 (Psi1^T Y)(Psi1^T Y)^T) - KL(q(X)||p(X))

Implementation uses the numerically superior B-form (B = I + beta Lm^-1 Psi2
Lm^-T, so log|K_MM| - log|A| = -log|B| and A^-1 = Lm^-T B^-1 Lm^-1); the test
oracle (tests/oracle.py) uses the direct A-form as an independent check.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve, solve_triangular

from gparml.ops import ard_rbf
from gparml.ops.psi import SufficientStats

_HALF_LOG_2PI = 0.9189385332046727417803297364056176


def _chol_psi2(psi2: jnp.ndarray) -> jnp.ndarray:
    """float32 Cholesky of the PSD-in-exact-arithmetic Psi2 with a
    scale-aware jitter ladder.

    Psi2's float32 round-off makes its smallest eigenvalues ~ -eps*lam_max
    (observed -1.2e-4 against lam_max 1.4e4 at M=200), and a float32 Cholesky
    needs cond <~ 1/(M*eps) to complete, so the jitter must scale with the
    LARGEST eigenvalue (<= trace), not the mean: the previous 1e-6*tr/M
    left cond ~ 3.5e8 and NaN'd every f32 bound at M >= 200. First try
    30*eps*tr (relative distortion ~4e-6); if that Cholesky still fails,
    fall back to 3000*eps*tr (~4e-4 — well inside the f32 parity tolerance,
    and the clamps in bound_from_stats bound the damage).

    The first-rung PROBE runs on stop_gradient(psi2): a Cholesky whose
    primal is NaN poisons its VJP even under a zero cotangent, so selecting
    between two cholesky() results with jnp.where keeps the failed rung's
    NaN in the autodiff graph — forward finite, gradients all-NaN, exactly
    in the ill-conditioned regime the ladder exists for. Only
    the jitter SCALAR is selected; a single differentiable Cholesky runs."""
    m = psi2.shape[0]
    dtype = psi2.dtype
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    tr = jnp.trace(psi2)
    eye = jnp.eye(m, dtype=dtype)
    probe = jnp.linalg.cholesky(
        jax.lax.stop_gradient(psi2) + (30.0 * eps * jax.lax.stop_gradient(tr)) * eye
    )
    ok = jnp.all(jnp.isfinite(probe))
    jit_scale = jnp.where(ok, dtype.type(30.0), dtype.type(3000.0))
    return jnp.linalg.cholesky(psi2 + (jit_scale * eps * tr) * eye)


def bound_from_stats(
    stats: SufficientStats,
    z: jnp.ndarray,
    sf2,
    alpha,
    beta,
    d: int,
    jitter: float = 1e-6,
) -> jnp.ndarray:
    """Evidence lower bound F from (already reduced) sufficient statistics.

    Args:
      stats: global SufficientStats (after psum across the data mesh axis).
      z: (M, Q) inducing inputs.
      sf2, alpha, beta: kernel signal variance, ARD precisions, noise precision.
      d: static output dimensionality D (stats.psi1_y is (M, D)).
      jitter: relative jitter for the K_MM Cholesky.

    Returns:
      scalar F (to be *maximized*).
    """
    m = z.shape[0]
    dtype = stats.psi2.dtype
    n_f = stats.n

    kmm = ard_rbf.kmm(z, sf2, alpha, jitter=jitter)
    lm = jnp.linalg.cholesky(kmm)

    if dtype == jnp.float64:
        # exact B-form (oracle-parity path)
        tmp = solve_triangular(lm, stats.psi2, lower=True)
        c2 = solve_triangular(lm, tmp.T, lower=True)
        tr_kinv_psi2 = jnp.trace(c2)
        b = jnp.eye(m, dtype=dtype) + beta * 0.5 * (c2 + c2.T)
    else:
        # float32: K_MM condition numbers squared through Lm^-1 Psi2 Lm^-T can
        # push B indefinite (round-off ~eps*kappa^2 exceeds 1). Factor
        # Psi2 ~= Lp Lp^T and form C2 = W W^T with W = Lm^-1 Lp — PSD by
        # construction, so chol(B) cannot NaN; accuracy degrades gracefully
        # instead of failing.
        lp_f = _chol_psi2(stats.psi2)
        w = solve_triangular(lm, lp_f, lower=True)
        # Clamp to the exact inequality tr(K_MM^-1 Psi2) <= psi0 (per point,
        # <q_nn> <= <k_nn>): float32 solves through an ill-conditioned Lm
        # can overshoot it by O(eps*kappa^2), and an optimizer will then
        # drive kappa up to mine the artifact (beta/sf2 runaway, alpha -> 0
        # — observed). The clamp zeroes the artifact's gradient instead.
        tr_kinv_psi2 = jnp.minimum(jnp.sum(w * w), stats.psi0)
        b = jnp.eye(m, dtype=dtype) + beta * jnp.matmul(
            w, w.T, precision="highest"
        )
    lb = jnp.linalg.cholesky(b)
    log_det_b = 2.0 * jnp.sum(jnp.log(jnp.diagonal(lb)))

    # tr(A^-1 (Psi1^T Y)(Psi1^T Y)^T) = || LB^-1 Lm^-1 Psi1^T Y ||_F^2
    c1 = solve_triangular(lm, stats.psi1_y, lower=True)
    cb = solve_triangular(lb, c1, lower=True)
    quad = jnp.sum(cb * cb)
    if dtype != jnp.float64:
        # Exact inequality beta^2 quad <= beta yy (A >= beta Psi2 >= beta
        # Psi1^T Psi1 since per-point <k k^T> - <k><k>^T is a covariance);
        # same float32 overshoot protection as the trace clamp above.
        quad = jnp.minimum(quad, stats.yy / beta)

    f = (
        -n_f * d * _HALF_LOG_2PI
        + 0.5 * n_f * d * jnp.log(beta)
        - 0.5 * d * log_det_b
        - 0.5 * beta * stats.yy
        - 0.5 * beta * d * stats.psi0
        + 0.5 * beta * d * tr_kinv_psi2
        + 0.5 * beta * beta * quad
        - stats.kl
    )
    return f


def posterior(stats: SufficientStats, z, sf2, alpha, beta, jitter: float = 1e-6):
    """Collapsed optimal q(u) pieces for prediction.

    Returns (lm, lb, a_inv_psi1y) with A^-1 Psi1^T Y = Lm^-T B^-1 Lm^-1 Psi1^T Y;
    the predictive mean at X* is beta * K_{*M} (A^-1 Psi1^T Y).
    """
    m = z.shape[0]
    dtype = stats.psi2.dtype
    kmm = ard_rbf.kmm(z, sf2, alpha, jitter=jitter)
    lm = jnp.linalg.cholesky(kmm)
    if dtype == jnp.float64:
        tmp = solve_triangular(lm, stats.psi2, lower=True)
        c2 = solve_triangular(lm, tmp.T, lower=True)
        b = jnp.eye(m, dtype=dtype) + beta * 0.5 * (c2 + c2.T)
    else:
        # PSD-by-construction float32 path (see bound_from_stats)
        lp_f = _chol_psi2(stats.psi2)
        w = solve_triangular(lm, lp_f, lower=True)
        b = jnp.eye(m, dtype=dtype) + beta * jnp.matmul(w, w.T, precision="highest")
    lb = jnp.linalg.cholesky(b)
    c1 = solve_triangular(lm, stats.psi1_y, lower=True)
    cb = cho_solve((lb, True), c1)
    a_inv_psi1y = solve_triangular(lm, cb, lower=True, trans=1)
    return lm, lb, a_inv_psi1y


def predict(
    x_star: jnp.ndarray,
    stats: SufficientStats,
    z: jnp.ndarray,
    sf2,
    alpha,
    beta,
    jitter: float = 1e-6,
):
    """Predictive mean and (diagonal, latent-f + noise) variance at X*.

    mean(x*) = beta K_{*M} A^-1 Psi1^T Y
    var(x*)  = k(x*,x*) - K_{*M} (K_MM^-1 - A^-1) K_{M*} + 1/beta
    (SURVEY.md Appendix A "Predictive".)
    """
    lm, lb, a_inv_psi1y = posterior(stats, z, sf2, alpha, beta, jitter=jitter)
    ksm = ard_rbf.k(x_star, z, sf2, alpha)
    mean = beta * jnp.matmul(ksm, a_inv_psi1y, precision="highest")

    t1 = solve_triangular(lm, ksm.T, lower=True)          # Lm^-1 K_{M*}
    t2 = solve_triangular(lb, t1, lower=True)             # LB^-1 Lm^-1 K_{M*}
    kss = ard_rbf.k_diag(x_star, sf2)
    var_f = kss - jnp.sum(t1 * t1, axis=0) + jnp.sum(t2 * t2, axis=0)
    return mean, var_f + 1.0 / beta


def predict_uncertain(
    mu_star: jnp.ndarray,
    s_star: jnp.ndarray,
    stats: SufficientStats,
    z: jnp.ndarray,
    sf2,
    alpha,
    beta,
    jitter: float = 1e-6,
    block: int = 1024,
):
    """Predictive mean/variance at UNCERTAIN inputs q(x*) = N(mu*, diag(s*))
    (the Bayesian-GPLVM reconstruction: expectations of the predictor under
    q(x*), using Psi1 rows in place of kernel rows).

      mean(y*) = beta * Psi1(x*) A^-1 Psi1^T Y
      var      = sf2 - tr((K_MM^-1 - A^-1) Psi2*) + 1/beta   (per output dim,
                 the standard first-moment variance approximation)

    The per-point traces are Frobenius inner products against FIXED matrices,
    tr(C Psi2*_n) = <C, Psi2*_n>_F with C in {K_MM^-1, A^-1}, so they need no
    per-point solves: both inverses are formed once (each one M x M
    triangular inversion + matmul) and a lax.scan over N*-blocks contracts
    (block, M, M) Psi2 slabs against them — O(block*M^2) working set at any
    N* (the previous vmap materialized all N* (M, M) slabs at once: ~10 GB
    at M=500, N*=1e4).
    """
    from gparml.ops import psi as psi_ops

    lm, lb, a_inv_psi1y = posterior(stats, z, sf2, alpha, beta, jitter=jitter)
    p1s = psi_ops.psi1(mu_star, s_star, z, sf2, alpha)       # (N*, M)
    mean = beta * jnp.matmul(p1s, a_inv_psi1y, precision="highest")

    m = z.shape[0]
    lm_inv = solve_triangular(lm, jnp.eye(m, dtype=lm.dtype), lower=True)
    c_k = jnp.matmul(lm_inv.T, lm_inv, precision="highest")   # K_MM^-1
    wb = solve_triangular(lb, lm_inv, lower=True)             # LB^-1 Lm^-1
    c_a = jnp.matmul(wb.T, wb, precision="highest")           # A^-1

    n_star, q = mu_star.shape
    if n_star == 0:
        # empty test batch: mean is already (0, D); variance matches
        return mean, jnp.zeros((0,), mu_star.dtype)
    b = max(1, min(block, n_star))
    pad = (-n_star) % b
    if pad:
        # padded rows (mu=0, s=1) are valid psi2 inputs; their traces are
        # computed and discarded below
        mu_p = jnp.concatenate(
            [mu_star, jnp.zeros((pad, q), mu_star.dtype)], axis=0)
        s_p = jnp.concatenate(
            [s_star, jnp.ones((pad, q), s_star.dtype)], axis=0)
    else:
        mu_p, s_p = mu_star, s_star
    nb = mu_p.shape[0] // b

    def body(_, xs):
        mub, sb = xs
        log_e0, const_n, v, c = psi_ops._psi2_pieces(mub, sb, z, sf2, alpha)
        bq = jnp.einsum("nq,mq,pq->nmp", c, z, z, precision="highest")
        p2 = jnp.exp(
            const_n[:, None, None] + v[:, :, None] + v[:, None, :]
            - 0.5 * bq + log_e0[None]
        )                                                     # (b, M, M)
        tr_k = jnp.einsum("nmp,mp->n", p2, c_k, precision="highest")
        tr_a = jnp.einsum("nmp,mp->n", p2, c_a, precision="highest")
        return None, (tr_k, tr_a)

    _, (tr_k, tr_a) = jax.lax.scan(
        body, None, (mu_p.reshape(nb, b, q), s_p.reshape(nb, b, q)))
    tr_k = tr_k.reshape(-1)[:n_star]
    tr_a = tr_a.reshape(-1)[:n_star]
    var_f = sf2 - tr_k + tr_a
    return mean, jnp.maximum(var_f, 0.0) + 1.0 / beta
