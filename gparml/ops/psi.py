"""Psi-statistics (Gaussian expectations of the ARD-RBF kernel) — pure JAX.

This is the mathematical core of the framework, the XLA engine, and the
reference for the GPU kernel in ``psi_gpu.py``. It re-designs the reference's
``partial_terms.py`` psi-statistic code (SURVEY.md §2 [C-HIGH], statistic names
``exp_K_ii``/``exp_K_mi``/``exp_K_mi_K_im`` [C-MED]) for XLA:

  * closed forms are written as batched matmuls + elementwise exp,
  * all derivatives (the reference hand-codes dF/d{Z, alpha, sf2, beta, mu, s})
    come from ``jax.grad`` of these forward evaluations,
  * the O(N·M²) Psi2 accumulation runs as a blocked ``lax.scan`` with
    rematerialization, so memory stays O(block·M²) for arbitrary N; the block
    is derived from N, M and the dtype unless the caller names one, and a
    last partial block is padded with weight-0 rows.

Definitions (q(x_n) = N(mu_n, diag(s_n)), SURVEY.md Appendix A — numerically
verified against Monte-Carlo in the survey session):

  psi0        = sum_n <k(x_n, x_n)>           = N * sf2
  Psi1[n, m]  = <k(x_n, z_m)>
              = sf2 * prod_q (alpha_q s_nq + 1)^(-1/2)
                    * exp(-1/2 alpha_q (mu_nq - z_mq)^2 / (alpha_q s_nq + 1))
  Psi2[m, m'] = sum_n <k(x_n, z_m) k(x_n, z_m')>
              = sum_n sf2^2 * prod_q (2 alpha_q s_nq + 1)^(-1/2)
                  * exp(- alpha_q (zb_q - mu_nq)^2 / (2 alpha_q s_nq + 1)
                        - 1/4 alpha_q (z_mq - z_m'q)^2),   zb = (z_m + z_m')/2

In the s -> 0 limit: Psi1 -> K_NM, Psi2 -> K_NM^T K_NM, psi0 -> N sf2 (used by
the SGPR fixed-inputs path, where no expectations are needed at all).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from gparml.ops import ard_rbf


class SufficientStats(NamedTuple):
    """Per-shard (or global, after psum) sufficient statistics of the bound.

    These are exactly the quantities the reference's MapReduce layer sums over
    partitions (``local_MapReduce.py`` reduce step, SURVEY.md §3.4): every
    field is a plain sum over data points n, so the decomposition is exact
    under any partition of N.
    """

    psi0: jnp.ndarray     # () : sum_n <k_nn>
    psi1_y: jnp.ndarray   # (M, D) : Psi1^T Y
    psi2: jnp.ndarray     # (M, M) : sum_n Psi2_n
    yy: jnp.ndarray       # () : sum_{n,d} Y[n,d]^2
    kl: jnp.ndarray       # () : KL(q(X) || N(0, I)) partial sum
    n: jnp.ndarray        # () : number of data points (constant wrt params)

    def __add__(self, other: "SufficientStats") -> "SufficientStats":
        return jax.tree.map(jnp.add, self, other)


def psi1(mu: jnp.ndarray, s: jnp.ndarray, z: jnp.ndarray, sf2, alpha) -> jnp.ndarray:
    """Psi1 matrix, shape (N, M)."""
    denom = alpha * s + 1.0                          # (N, Q)
    log_norm = -0.5 * jnp.sum(jnp.log(denom), axis=-1)   # (N,)
    c = alpha / denom                                 # (N, Q)
    # -1/2 sum_q c_nq (mu_nq - z_mq)^2
    #   = -1/2 [ sum_q c mu^2 - 2 sum_q c mu z + sum_q c z^2 ]
    cm2 = jnp.sum(c * mu * mu, axis=-1)               # (N,)
    cmz = jnp.matmul(c * mu, z.T, precision='highest')  # (N, M)
    cz2 = jnp.matmul(c, (z * z).T, precision='highest') # (N, M)
    quad = -0.5 * (cm2[:, None] - 2.0 * cmz + cz2)
    return sf2 * jnp.exp(log_norm[:, None] + quad)


def psi2_sum(
    mu: jnp.ndarray, s: jnp.ndarray, z: jnp.ndarray, sf2, alpha,
    weights: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """sum_n w_n * Psi2_n, shape (M, M). Materializes (N, M, M) — small N only.

    Decomposition used:
      log Psi2[n,m,m'] = const_n + v_n[m] + v_n[m'] - 1/2 B_n[m,m'] + E0[m,m']
    with c_nq = alpha_q / (2 alpha_q s_nq + 1):
      E0[m,m']  = -1/4 sum_q alpha_q (z_mq - z_m'q)^2        (n-independent)
      B_n[m,m'] = sum_q c_nq z_mq z_m'q                      (per-n matmul)
      v_n[m]    = -1/4 sum_q c_nq z_mq^2 + 1/2 sum_q c_nq mu_nq z_mq ... see below
    """
    log_e0, const_n, v, c = _psi2_pieces(mu, s, z, sf2, alpha)
    # B_n[m,m'] = sum_q c_nq z_mq z_m'q : batched matmul (N,M,M) at HIGHEST —
    # the exponent reaches ~10 in magnitude, so TF32's 1e-3 relative error
    # would be a ~1% error in Psi2.
    b = jnp.einsum("nq,mq,pq->nmp", c, z, z, precision="highest")
    log_psi2 = (
        const_n[:, None, None]
        + v[:, :, None]
        + v[:, None, :]
        - 0.5 * b
        + log_e0[None, :, :]
    )
    p2 = jnp.exp(log_psi2)
    if weights is not None:
        p2 = p2 * weights[:, None, None]
    return jnp.sum(p2, axis=0)


def _psi2_pieces(mu, s, z, sf2, alpha):
    """Shared scalar/vector pieces of the Psi2 decomposition.

    Returns (log_e0 (M,M), const_n (N,), v (N,M), c (N,Q)).

    Derivation: with a=alpha_q, den = 2 a s + 1, c = a/den, u=z_mq, w=z_m'q,
      -a(zb - mu)^2/den - a/4 (u-w)^2
      = -(c/4)(u^2 + w^2 + 2uw) + c mu (u + w) - c mu^2 - (a/4)(u^2 + w^2 - 2uw)
      = [-(c+a)/4 u^2 + c mu u] + [same in w] + ((a - c)/2) u w - c mu^2
    and (a - c)/2 = a^2 s / den / ... note a - c = a(1 - 1/den) = 2 a^2 s/den,
    so the uw coefficient is a^2 s / den. We fold the n-independent -a/4 u w
    ... instead we keep E0 = -1/4 a (u - w)^2 verbatim and define
      B_n[m,m'] = sum_q c_nq u w   (so -1/2 B_n + E0 reproduces the cross terms:
      E0 contributes +a/2 uw and -a/4(u^2+w^2); -c/4(u^2+w^2) - c/2 uw from the
      first factor; total uw coeff = (a - c)/2 ✓, total u^2 coeff = -(a+c)/4 ✓).
      v_n[m]    = -1/4 sum_q c_nq u^2 + sum_q c_nq mu_nq u
      const_n   = 2 log sf2 - 1/2 sum_q log den_nq - sum_q c_nq mu_nq^2
    """
    den = 2.0 * alpha * s + 1.0                       # (N, Q)
    c = alpha / den                                   # (N, Q)
    log_e0 = -0.25 * ard_rbf.sq_dist(z, z, alpha)     # (M, M)
    const_n = (
        2.0 * jnp.log(sf2)
        - 0.5 * jnp.sum(jnp.log(den), axis=-1)
        - jnp.sum(c * mu * mu, axis=-1)
    )                                                 # (N,)
    v = -0.25 * jnp.matmul(c, (z * z).T, precision='highest') + jnp.matmul(c * mu, z.T, precision='highest')  # (N, M)
    return log_e0, const_n, v, c


def kl_qp(
    mu: jnp.ndarray, s: jnp.ndarray, weights: Optional[jnp.ndarray] = None
) -> jnp.ndarray:
    """KL( prod_n N(mu_n, diag(s_n)) || N(0, I) ), a plain sum over (n, q)."""
    per_n = 0.5 * jnp.sum(mu * mu + s - jnp.log(s) - 1.0, axis=-1)
    if weights is not None:
        per_n = per_n * weights
    return jnp.sum(per_n)


# One scan step's slab — (block, M, M) for the GPLVM's Psi2, (block, M) for
# K_NM / Psi1 — is kept at or under this many bytes.
SLAB_BYTES = 1 << 30


def derive_block(n: int, m: int, itemsize: int, latent: bool = True) -> int:
    """Rows per scan step so that one step's slab stays within SLAB_BYTES.

    Returns ``n`` when every row fits in one slab (the unblocked path).
    Otherwise the blocks are made equal, a multiple of 8 rows, and as few
    as the bound allows, so the padded last block wastes little."""
    per_row = m * (m if latent else 1) * itemsize
    cap = max(8, SLAB_BYTES // per_row)
    if n <= cap:
        return n
    nb = -(-n // cap)        # fewest blocks within the bound
    rows = -(-n // nb)       # equal blocks
    return -(-rows // 8) * 8


def _resolve_block(block, n, m, dtype, latent):
    if block is None:
        block = derive_block(n, m, jnp.dtype(dtype).itemsize, latent)
    return min(int(block), n)


def totals(y, mu, s, sf2, weights=None, rows_axis: int = 0):
    """(psi0, sum y^2, KL, n): the O(N) statistics, row-weighted.

    ``rows_axis=1`` reads (D, N) / (Q, N) arrays (the transposed layout)."""
    if weights is None:
        n_f = jnp.asarray(y.shape[rows_axis], dtype=y.dtype)
        yy = jnp.sum(y * y)
    else:
        n_f = jnp.sum(weights)
        w_b = weights[:, None] if rows_axis == 0 else weights[None, :]
        yy = jnp.sum((y * w_b) * y)
    if s is None:
        kl = jnp.zeros((), dtype=y.dtype)
    elif rows_axis == 0:
        kl = kl_qp(mu, s, weights)
    else:
        kl = kl_qp(mu.T, s.T, weights)
    return n_f * sf2, yy, kl, n_f


def _scan_stats(y, mu, s, z, sf2, alpha, weights, block, *, with_psi2,
                rows_axis=0, vary_axis=None):
    """Blocked (Psi1^T Y, sum Psi2) over N in steps of ``block`` rows.

    Each step is rematerialized (jax.checkpoint), so the working set is one
    block's slab. N need not be a multiple of ``block``: the last block is
    padded with weight-0 rows (mu=0, s=1, y=0), which add nothing to any
    statistic or gradient. ``s=None`` is the SGPR fixed-inputs limit
    (Psi1 = K_NM, Psi2 = K_NM^T K_NM). ``with_psi2=False`` returns only
    Psi1^T Y (the GPU engine computes Psi2 itself). ``rows_axis=1`` takes
    (D, N) / (Q, N) arrays and transposes one block at a time."""
    n = y.shape[rows_axis]
    m = z.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    w = jnp.ones((n,), dtype=y.dtype) if weights is None else weights

    def pad_rows(a, value, axis=rows_axis):
        if not pad:
            return a
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, pad)
        return jnp.pad(a, widths, constant_values=value)

    def split(a):
        # (N, k) -> (nb, block, k); (k, N) -> (nb, k, block)
        if rows_axis == 0:
            return a.reshape((nb, block) + a.shape[1:])
        return jnp.swapaxes(a.reshape(a.shape[0], nb, block), 0, 1)

    xs = [split(pad_rows(y, 0.0)), split(pad_rows(mu, 0.0)),
          pad_rows(w, 0.0, axis=0).reshape(nb, block)]
    if s is not None:
        xs.append(split(pad_rows(s, 1.0)))

    # Only the block's own statistics are rematerialized: the running sums
    # stay outside the checkpoint, so the backward pass keeps no (M, M)
    # carry per step.
    @jax.checkpoint
    def block_stats(xs):
        yb, mub, wb = xs[:3]
        sb = xs[3] if s is not None else None
        if rows_axis == 1:
            yb, mub = yb.T, mub.T
            sb = None if sb is None else sb.T
        if sb is None:
            p1b = ard_rbf.k(mub, z, sf2, alpha)
        else:
            p1b = psi1(mub, sb, z, sf2, alpha)
        out = [jnp.matmul(p1b.T, yb * wb[:, None], precision="highest")]
        if with_psi2:
            if sb is None:
                kw = p1b * jnp.sqrt(wb)[:, None]
                out.append(jnp.matmul(kw.T, kw, precision="highest"))
            else:
                out.append(psi2_sum(mub, sb, z, sf2, alpha, wb))
        return tuple(out)

    def body(carry, xs):
        return tuple(c + b for c, b in zip(carry, block_stats(xs))), None

    init = (jnp.zeros((m, y.shape[1 - rows_axis]), dtype=y.dtype),)
    if with_psi2:
        init = init + (jnp.zeros((m, m), dtype=y.dtype),)
    if vary_axis is not None:
        init = jax.lax.pcast(init, vary_axis, to="varying")
    out, _ = jax.lax.scan(body, init, tuple(xs))
    return out


def psi1_y(y, mu, s, z, sf2, alpha, weights=None, block=None, vary_axis=None):
    """Psi1^T Y (M, D), row-weighted; blocked so the (block, M) Psi1 slab
    stays within SLAB_BYTES at any N."""
    n = y.shape[0]
    block = _resolve_block(block, n, z.shape[0], y.dtype, latent=False)
    (p1y,) = _scan_stats(y, mu, s, z, sf2, alpha, weights, block,
                         with_psi2=False, vary_axis=vary_axis)
    return p1y


def suff_stats(
    y: jnp.ndarray,
    mu: jnp.ndarray,
    s: Optional[jnp.ndarray],
    z: jnp.ndarray,
    sf2,
    alpha,
    block: Optional[int] = None,
    weights: Optional[jnp.ndarray] = None,
    vary_axis: Optional[str] = None,
) -> SufficientStats:
    """Sufficient statistics {psi0, Psi1^T Y, sum Psi2, sum y^2, KL, n}.

    Args:
      y: (N, D) observations.
      mu: (N, Q) variational means (GPLVM) or observed inputs X (SGPR).
      s: (N, Q) variational variances, or None for the SGPR fixed-inputs path
         (the exact s=0 limit: Psi1 = K_NM, Psi2 = K_NM^T K_NM, KL = 0).
      z: (M, Q) inducing inputs.
      sf2, alpha: kernel hypers (positive; alpha shape (Q,)).
      block: rows per step of the blocked lax.scan + remat. None derives it
         from N, M and the dtype (derive_block); any N works, the last
         block is padded with weight-0 rows.
      weights: optional (N,) per-point weights (0/1 masks for padded shards,
         or fractional weights for minibatch scaling). All statistics become
         sum_n w_n * (...); ``n`` becomes sum_n w_n.
      vary_axis: mesh axis name when called inside a shard_map body with
         varying-manual-axes checking on — the blocked scan's zero init must
         be marked device-varying (lax.pcast) to type-match the carry.

    Returns SufficientStats with dtype following the inputs.
    """
    n = y.shape[0]
    psi0, yy, kl, n_f = totals(y, mu, s, sf2, weights)
    block = _resolve_block(block, n, z.shape[0], y.dtype, latent=s is not None)
    if block < n:
        p1y, p2 = _scan_stats(y, mu, s, z, sf2, alpha, weights, block,
                              with_psi2=True, vary_axis=vary_axis)
        return SufficientStats(psi0, p1y, p2, yy, kl, n_f)

    yw = y if weights is None else y * weights[:, None]
    if s is None:
        knm = ard_rbf.k(mu, z, sf2, alpha)
        p1y = jnp.matmul(knm.T, yw, precision='highest')
        knm_w = knm if weights is None else knm * jnp.sqrt(weights)[:, None]
        p2 = jnp.matmul(knm_w.T, knm_w, precision='highest')
    else:
        p1 = psi1(mu, s, z, sf2, alpha)
        p1y = jnp.matmul(p1.T, yw, precision='highest')
        p2 = psi2_sum(mu, s, z, sf2, alpha, weights)
    return SufficientStats(psi0, p1y, p2, yy, kl, n_f)


def suff_stats_t(
    y_t: jnp.ndarray,
    mu_t: jnp.ndarray,
    s_t: Optional[jnp.ndarray],
    z: jnp.ndarray,
    sf2,
    alpha,
    block: Optional[int] = None,
    weights: Optional[jnp.ndarray] = None,
) -> SufficientStats:
    """Sufficient statistics from the transposed layout via the blocked scan.

    The engine for GPLVMConfig(layout='qn', y_layout='dn') and SGPR/SVGP
    layout='qn': inputs are stored transposed — y_t (D, N), mu_t/s_t (Q, N).
    Each scan step transposes ONE (Q, block) slab into row-major form and
    reuses the psi1/psi2_sum math verbatim, so no whole-array row-major copy
    is ever made. ``s_t=None`` is the SGPR (observed inputs, s ≡ 0) mode.
    ``block`` follows suff_stats.
    """
    n = mu_t.shape[1]
    block = _resolve_block(block, n, z.shape[0], y_t.dtype,
                           latent=s_t is not None)
    if block >= n:
        return suff_stats(y_t.T, mu_t.T, None if s_t is None else s_t.T, z,
                          sf2, alpha, block=n, weights=weights)
    psi0, yy, kl, n_f = totals(y_t, mu_t, s_t, sf2, weights, rows_axis=1)
    p1y, p2 = _scan_stats(y_t, mu_t, s_t, z, sf2, alpha, weights, block,
                          with_psi2=True, rows_axis=1)
    return SufficientStats(psi0, p1y, p2, yy, kl, n_f)
