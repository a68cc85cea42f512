"""Sum over n of Psi2 on the GPU: fused Pallas kernels through Triton.

Psi2 is the only N·M²-sized work in the program (``ops/psi.py``). The XLA
engine writes a (block, M, M) slab to device memory on every pass; these
kernels keep it in registers. They rest on one identity. With
c_nq = alpha_q / (2 alpha_q s_nq + 1) and zb = (z_m + z_m') / 2,

  log Psi2_n[m, m'] = E0[m, m'] + const_n + sum_q 2 c_nq mu_nq zb_q
                      - sum_q c_nq zb_q^2
                    = F[n] . G[:, p]            for the pair p = (m, m'),

  F[n]    = (1, const_n, c_n * mu_n, c_n)       row features, width 2Q + 2
  G[:, p] = (E0_p, 1, 2 zb_p, -zb_p^2)          pair features

where const_n = 2 log sf2 - 1/2 sum_q log(2 alpha_q s_nq + 1)
- sum_q c_nq mu_nq^2 and E0 = -1/4 sum_q alpha_q (z_mq - z_m'q)^2. So
sum_n w_n Psi2_n[p] = sum_n w_n exp(F @ G)[n, p]: a matrix product, an exp
and a weighted column sum. Only the pairs m <= m' are computed.

Three kernels, each a grid of independent programs (nothing is carried from
one program to another, so sums across programs are a second XLA pass):

  forward  grid (pair block, row split): partial sums (splits, P)
  dF       grid (row block), loops over every pair block: exact per-row
           dL/dF and dL/dw
  dG       grid (pair block, row split): partial dL/dG (splits, P, K)

Gradients with respect to mu, s, z, alpha and sf2 reach F and G through
ordinary autodiff of the feature maps below. The products run in float32
on the tensor cores as three TF32 passes (TF32x3): plain TF32 keeps ~3
decimal digits, which on an exponent of magnitude ~10 is a ~1% error in
Psi2.

``interpret=True`` runs the same kernels in the Pallas interpreter (CPU
tests); nothing else ever selects it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from gparml.ops import psi

# Tile sizes from a sweep on an H100 (PERF.md): 64 rows x 64 pairs, 4 warps,
# 3 pipeline stages.
_BN = 64            # rows per inner step
_BP = 64            # pairs per program
_PROGRAMS = 1024    # enough programs in flight to fill every SM of the card
_NUM_WARPS = 4
_NUM_STAGES = 3
_GPU_PRECISION = lax.DotAlgorithmPreset.TF32_TF32_F32_X3


def feature_width(q: int) -> int:
    """K: 2Q + 2 row/pair features, padded to a power of two >= 16 (the
    Triton product's smallest operand width)."""
    return max(16, pl.next_power_of_2(2 * q + 2))


def row_features(mu, s, sf2, alpha, k: int):
    """F (N, K) in float32."""
    den = 2.0 * alpha * s + 1.0
    c = alpha / den
    const = (2.0 * jnp.log(sf2) - 0.5 * jnp.sum(jnp.log(den), axis=1)
             - jnp.sum(c * mu * mu, axis=1))
    n, q = mu.shape
    f = jnp.concatenate(
        [jnp.ones((n, 1), mu.dtype), const[:, None], c * mu, c,
         jnp.zeros((n, k - 2 - 2 * q), mu.dtype)], axis=1)
    return f.astype(jnp.float32)


def pair_features(z, alpha, k: int):
    """G (K, P) in float32 for the upper-triangle pairs (np.triu_indices)."""
    m, q = z.shape
    iu, ju = np.triu_indices(m)
    zb = 0.5 * (z[iu] + z[ju])
    dz = z[iu] - z[ju]
    e0 = -0.25 * jnp.sum(alpha * dz * dz, axis=1)
    p = iu.shape[0]
    g = jnp.concatenate(
        [e0[:, None], jnp.ones((p, 1), z.dtype), 2.0 * zb, -zb * zb,
         jnp.zeros((p, k - 2 - 2 * q), z.dtype)], axis=1)
    return g.T.astype(jnp.float32)


def _pair_index(m: int) -> np.ndarray:
    """(M, M) index of each entry's pair in the triu_indices order."""
    iu, ju = np.triu_indices(m)
    idx = np.empty((m, m), np.int32)
    idx[iu, ju] = np.arange(iu.shape[0], dtype=np.int32)
    idx[ju, iu] = idx[iu, ju]
    return idx


def _fwd_kernel(f_ref, g_ref, w_ref, o_ref, *, steps, precision):
    g = g_ref[...]

    def body(i, acc):
        rows = pl.ds(i * _BN, _BN)
        e = jnp.exp(pl.dot(f_ref[rows, :], g, precision=precision))
        return acc + jnp.sum(e * w_ref[rows][:, None], axis=0)

    o_ref[...] = lax.fori_loop(0, steps, body, jnp.zeros((_BP,), jnp.float32))


def _df_kernel(f_ref, g_ref, ct_ref, w_ref, df_ref, dw_ref, *, steps,
               precision):
    f = f_ref[...]
    k = f.shape[1]

    def body(j, carry):
        acc_f, acc_w = carry
        cols = pl.ds(j * _BP, _BP)
        g = g_ref[:, cols]
        t = jnp.exp(pl.dot(f, g, precision=precision)) * ct_ref[cols][None, :]
        return (acc_f + pl.dot(t, g, trans_b=True, precision=precision),
                acc_w + jnp.sum(t, axis=1))

    acc_f, acc_w = lax.fori_loop(
        0, steps, body,
        (jnp.zeros((_BN, k), jnp.float32), jnp.zeros((_BN,), jnp.float32)))
    df_ref[...] = acc_f * w_ref[...][:, None]
    dw_ref[...] = acc_w


def _dg_kernel(f_ref, g_ref, ct_ref, w_ref, dg_ref, *, steps, precision):
    g = g_ref[...]
    ct = ct_ref[...]
    k = g.shape[0]

    def body(i, acc):
        rows = pl.ds(i * _BN, _BN)
        f = f_ref[rows, :]
        t = jnp.exp(pl.dot(f, g, precision=precision)) * ct[None, :]
        fw = f * w_ref[rows][:, None]
        return acc + pl.dot(t, fw, trans_a=True, precision=precision)

    dg_ref[...] = lax.fori_loop(0, steps, body,
                                jnp.zeros((_BP, k), jnp.float32))


def _call(kernel, name, grid, in_specs, out_specs, out_shape, interpret,
          vma):
    out_shape = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, vma=vma), out_shape)
    return pl.pallas_call(
        kernel, out_shape=out_shape, grid=grid, in_specs=in_specs,
        out_specs=out_specs, interpret=interpret, name=name,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES),
    )


def _vma(*xs):
    return frozenset().union(*(jax.typeof(x).vma for x in xs))


def _varying(vma, *xs):
    """Mark each array varying over every axis in ``vma`` (inside shard_map):
    the custom VJP's cotangents must match their primals' types, and the
    pcast transposes to the psum that sums a replicated input's gradient."""
    out = []
    for x in xs:
        missing = tuple(sorted(vma - jax.typeof(x).vma))
        out.append(lax.pcast(x, missing, to="varying") if missing else x)
    return out


def _precision(interpret):
    # The interpreter runs on the CPU, which has no TF32 algorithm.
    return lax.Precision.HIGHEST if interpret else _GPU_PRECISION


def _fwd(f, g, w, splits, interpret):
    n_pad, k = f.shape
    p_pad = g.shape[1]
    rows = n_pad // splits
    kernel = functools.partial(_fwd_kernel, steps=rows // _BN,
                               precision=_precision(interpret))
    part = _call(
        kernel, "psi2_fwd", (p_pad // _BP, splits),
        [pl.BlockSpec((rows, k), lambda p, s: (s, 0)),
         pl.BlockSpec((k, _BP), lambda p, s: (0, p)),
         pl.BlockSpec((rows,), lambda p, s: (s,))],
        pl.BlockSpec((None, _BP), lambda p, s: (s, p)),
        jax.ShapeDtypeStruct((splits, p_pad), jnp.float32),
        interpret, _vma(f, g, w),
    )(f, g, w)
    return jnp.sum(part, axis=0)


def _df(f, g, ct, w, interpret):
    n_pad, k = f.shape
    p_pad = g.shape[1]
    kernel = functools.partial(_df_kernel, steps=p_pad // _BP,
                               precision=_precision(interpret))
    return _call(
        kernel, "psi2_bwd_rows", (n_pad // _BN,),
        [pl.BlockSpec((_BN, k), lambda i: (i, 0)),
         pl.BlockSpec((k, p_pad), lambda i: (0, 0)),
         pl.BlockSpec((p_pad,), lambda i: (0,)),
         pl.BlockSpec((_BN,), lambda i: (i,))],
        [pl.BlockSpec((_BN, k), lambda i: (i, 0)),
         pl.BlockSpec((_BN,), lambda i: (i,))],
        [jax.ShapeDtypeStruct((n_pad, k), jnp.float32),
         jax.ShapeDtypeStruct((n_pad,), jnp.float32)],
        interpret, _vma(f, g, ct, w),
    )(f, g, ct, w)


def _dg(f, g, ct, w, splits, interpret):
    n_pad, k = f.shape
    p_pad = g.shape[1]
    rows = n_pad // splits
    kernel = functools.partial(_dg_kernel, steps=rows // _BN,
                               precision=_precision(interpret))
    part = _call(
        kernel, "psi2_bwd_pairs", (p_pad // _BP, splits),
        [pl.BlockSpec((rows, k), lambda p, s: (s, 0)),
         pl.BlockSpec((k, _BP), lambda p, s: (0, p)),
         pl.BlockSpec((_BP,), lambda p, s: (p,)),
         pl.BlockSpec((rows,), lambda p, s: (s,))],
        pl.BlockSpec((None, _BP, k), lambda p, s: (s, p, 0)),
        jax.ShapeDtypeStruct((splits, p_pad, k), jnp.float32),
        interpret, _vma(f, g, ct, w),
    )(f, g, ct, w)
    return jnp.sum(part, axis=0).T


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def exp_pair_sum(f, g, w, splits, interpret=False):
    """sum_n w_n exp(f @ g)[n, :] for f (N, K), g (K, P), w (N,), all
    float32; N a multiple of _BN * splits and P a multiple of _BP."""
    return _fwd(f, g, w, splits, interpret)


def _exp_pair_sum_fwd(f, g, w, splits, interpret):
    return _fwd(f, g, w, splits, interpret), (f, g, w)


def _exp_pair_sum_bwd(splits, interpret, res, ct):
    f, g, w = res
    df, dw = _df(f, g, ct, w, interpret)
    return df, _dg(f, g, ct, w, splits, interpret), dw


exp_pair_sum.defvjp(_exp_pair_sum_fwd, _exp_pair_sum_bwd)


def grid_split(n: int, m: int) -> tuple[int, int, int]:
    """(splits, padded N, padded P): the row splits that bring the forward
    and dG grids to about _PROGRAMS programs, and the padded extents."""
    p = m * (m + 1) // 2
    p_pad = -(-p // _BP) * _BP
    row_blocks = -(-n // _BN)
    splits = max(1, min(-(-_PROGRAMS // (p_pad // _BP)), row_blocks))
    n_pad = -(-n // (_BN * splits)) * _BN * splits
    return splits, n_pad, p_pad


def psi2_sum(mu, s, z, sf2, alpha, weights=None, *, interpret=False):
    """sum_n w_n Psi2_n, shape (M, M), computed in float32 by the kernels.

    Any N (padded with weight-0 rows), any M (padded pairs are dropped) and
    any Q. The result takes the dtype of ``mu``."""
    n, q = mu.shape
    m = z.shape[0]
    k = feature_width(q)
    splits, n_pad, p_pad = grid_split(n, m)
    w = jnp.ones((n,), jnp.float32) if weights is None else weights
    f = jnp.pad(row_features(mu, s, sf2, alpha, k), ((0, n_pad - n), (0, 0)))
    g = pair_features(z, alpha, k)
    p = g.shape[1]
    g = jnp.pad(g, ((0, 0), (0, p_pad - p)))
    w = jnp.pad(w.astype(jnp.float32), (0, n_pad - n))
    f, g, w = _varying(_vma(f, g, w), f, g, w)
    sums = exp_pair_sum(f, g, w, splits, interpret)[:p]
    return sums[_pair_index(m)].astype(mu.dtype)


def suff_stats(y, mu, s, z, sf2, alpha, weights=None, vary_axis=None, *,
               interpret=False):
    """SufficientStats with sum Psi2 from the kernels and the O(N·M) rest
    (Psi1^T Y by the blocked XLA scan, psi0, sum y^2, KL) from ops/psi.py."""
    psi0, yy, kl, n_f = psi.totals(y, mu, s, sf2, weights)
    p1y = psi.psi1_y(y, mu, s, z, sf2, alpha, weights=weights,
                     vary_axis=vary_axis)
    p2 = psi2_sum(mu, s, z, sf2, alpha, weights, interpret=interpret)
    return psi.SufficientStats(psi0, p1y, p2, yy, kl, n_f)
