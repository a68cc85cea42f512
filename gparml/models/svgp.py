"""Stochastic variational sparse GP regression (uncollapsed bound).

BEYOND the reference's scope (GParML only implements the collapsed Titsias
bound, which requires full-data sufficient statistics per objective
evaluation): an explicit q(u) = N(m_d, L_d L_d^T) per output dimension makes
the data term a plain sum over points, so unbiased minibatch gradients exist
(Hensman, Fusi & Lawrence, "Gaussian Processes for Big Data", UAI 2013) and
training cost per step is O(B M^2) instead of O(N M^2). This means
arbitrarily large N with a fixed per-step footprint — the framework's
production-training mode; the collapsed models remain the exact/batch mode.

ELBO (Gaussian likelihood, noise precision beta):

  sum_n sum_d [ log N(y_nd | mu_nd, 1/beta) - beta/2 * var_nd ]
  - sum_d KL( N(m_d, S_d) || N(0, K_MM) )

  with A = K_nm K_MM^-1,  mu_n = A_n m,  var_nd = k_nn - q_nn + [A S_d A^T]_nn.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from gparml.models import params as P
from gparml.ops import ard_rbf
from gparml.utils import init as init_utils

_HALF_LOG_2PI = 0.9189385332046727417803297364056176

# Above this many rows the final-ELBO report switches from the exact
# full-data ELBO to an unbiased 4x-batch random-subset estimate (the exact
# term costs O(N*M^2*D) through the (D, M, B) projection — measured 8 s on a
# CPU host at N=2e5). FitResult.elbo_exact / .elbo_n record which estimator
# produced `.elbo`.
_EXACT_ELBO_MAX_N = 65536


@dataclass(frozen=True)
class SVGPConfig:
    num_inducing: int = 50
    bijector: str = "exp"
    jitter: float = 1e-6
    batch_size: int = 1024
    layout: str = "nq"               # 'qn': x is (Q, N), y is (D, N);
                                     # single-device only (the mesh path
                                     # owns rows)
    fixed_beta: bool = False
    fixed_z: bool = False
    fixed_hypers: bool = False


class SVGPParams(NamedTuple):
    glob: P.GlobalParams      # Z, kernel hypers, noise precision
    q_mu: jnp.ndarray         # (M, D) variational means of u
    q_sqrt: jnp.ndarray       # (D, M, M) lower-triangular scales of q(u)


class FitResult(NamedTuple):
    params: SVGPParams
    elbo: jnp.ndarray
    history: jnp.ndarray
    n_evals: jnp.ndarray
    # Final-ELBO estimator provenance (the estimator switches at
    # _EXACT_ELBO_MAX_N rows — without these fields the switch is silent and
    # `.elbo` across that threshold compares different estimators):
    # elbo_exact — True: `elbo` is the exact full-data ELBO; False: an
    # unbiased random-subset estimate. elbo_n — rows the estimate used.
    elbo_exact: bool = True
    elbo_n: int = 0


def init_params(key, x, y, config: SVGPConfig) -> SVGPParams:
    m = config.num_inducing
    if config.layout == "qn":
        # init math is row-major; a one-time transient (huge-N users pass
        # Z / hypers explicitly)
        x, y = x.T, y.T
    d = y.shape[1]
    z = init_utils.init_inducing(key, x, m)
    var_y = jnp.maximum(jnp.var(y), 1e-6)
    glob = P.make_global(
        z, var_y, 1.0 / jnp.maximum(jnp.var(x, axis=0), 1e-6), 10.0 / var_y,
        bijector=config.bijector,
    )
    glob = jax.tree.map(lambda a: a.astype(x.dtype), glob)
    q_mu = jnp.zeros((m, d), x.dtype)
    # start q(u) at the prior scale: L = chol(Kmm) would couple into hypers;
    # a small identity keeps early steps stable (standard SVGP init)
    q_sqrt = jnp.tile(jnp.eye(m, dtype=x.dtype)[None], (d, 1, 1)) * 0.1
    return SVGPParams(glob=glob, q_mu=q_mu, q_sqrt=q_sqrt)


def _tril(q_sqrt):
    return jnp.tril(q_sqrt)


def extend_for_wraparound(a, b: int, axis: int = 0):
    """Append the first ``b`` rows (along ``axis``) so a contiguous window
    of length ``b`` starting anywhere in [0, n) wraps around the end
    without a gather."""
    return jnp.concatenate(
        [a, jax.lax.slice_in_dim(a, 0, b, axis=axis)], axis=axis)


def minibatch_window(a_ext, start, b: int, axis: int = 0):
    """Length-``b`` contiguous window of the wraparound-extended array.

    With ``start`` drawn uniformly from {0, ..., n-1}, every one of the n
    underlying points has inclusion probability exactly b/n — unlike a
    non-wraparound window (start in {0..n-b}), which includes points near
    the array ends with probability as low as 1/(n-b+1) vs b/(n-b+1) in the
    middle (a 64x disparity at n=200, b=64)."""
    return jax.lax.dynamic_slice_in_dim(a_ext, start, b, axis=axis)


def _data_term(p: SVGPParams, x, y, weights, config: SVGPConfig):
    """WEIGHTED per-point data term sum over a batch:

      sum_n w_n [ d(-log sqrt(2 pi) + log(beta)/2)
                  - beta/2 (||y_n - mu_n||^2 + sum_d var_nd) ]

    Weights make the estimator exact under mesh padding (padded rows carry
    w=0) and reduce to the unweighted term at w=1."""
    z, sf2, alpha, beta = P.constrain(p.glob, config.bijector)
    b, d = y.shape
    m = z.shape[0]

    kmm = ard_rbf.kmm(z, sf2, alpha, jitter=config.jitter)
    lm = jnp.linalg.cholesky(kmm)
    # One M x M triangular inversion, then everything B-sized is a matrix
    # product (triangular solves are latency-bound sequential ops; with
    # B >> M it is cheaper to materialize Lm^-1 once).
    lm_inv = solve_triangular(lm, jnp.eye(m, dtype=x.dtype), lower=True)
    knm = ard_rbf.k(x, z, sf2, alpha)                  # (B, M)
    a = jnp.matmul(lm_inv, knm.T, precision="highest")  # (M, B): Lm^-1 Kmn
    # predictive pieces under q(u)
    mean = jnp.matmul(
        a.T, jnp.matmul(lm_inv, p.q_mu, precision="highest"),
        precision="highest",
    )                                                  # (B, D)
    knn = ard_rbf.k_diag(x, sf2)                       # (B,)
    qnn = jnp.sum(a * a, axis=0)                       # (B,)
    ls = _tril(p.q_sqrt)                               # (D, M, M)
    # var from q(u): || L_d^T Lm^-T a_n ||^2 per (n, d)
    proj = jnp.einsum(
        "dmk,mb->dkb", ls, jnp.matmul(lm_inv.T, a, precision="highest"),
        precision="highest",
    )                                                  # (D, M, B)
    var_q = jnp.sum(proj * proj, axis=1).T             # (B, D)
    var_f = (knn - qnn)[:, None] + var_q               # (B, D)

    resid = y - mean
    w = jnp.ones((b,), y.dtype) if weights is None else weights
    per_point = (
        d * (-_HALF_LOG_2PI + 0.5 * jnp.log(beta))
        - 0.5 * beta * (jnp.sum(resid * resid, axis=1) + jnp.sum(var_f, axis=1))
    )                                                  # (B,)
    return jnp.sum(w * per_point)


def _kl_qu(p: SVGPParams, d: int, config: SVGPConfig) -> jnp.ndarray:
    """KL(q(u_d) || N(0, Kmm)) summed over output dimensions (global term,
    computed on replicated parameters)."""
    z, sf2, alpha, _ = P.constrain(p.glob, config.bijector)
    m = z.shape[0]
    kmm = ard_rbf.kmm(z, sf2, alpha, jitter=config.jitter)
    lm = jnp.linalg.cholesky(kmm)
    lm_inv = solve_triangular(lm, jnp.eye(m, dtype=lm.dtype), lower=True)
    ls = _tril(p.q_sqrt)
    lm_inv_mu = jnp.matmul(lm_inv, p.q_mu, precision="highest")   # (M, D)
    lm_inv_ls = jnp.einsum("mk,dkj->dmj", lm_inv, ls, precision="highest")
    tr = jnp.sum(lm_inv_ls * lm_inv_ls)
    quad = jnp.sum(lm_inv_mu * lm_inv_mu)
    diag_ls = jnp.abs(jnp.diagonal(ls, axis1=1, axis2=2)) + 1e-20
    logdet_s = 2.0 * jnp.sum(jnp.log(diag_ls))
    logdet_k = 2.0 * jnp.sum(jnp.log(jnp.diagonal(lm))) * d
    return 0.5 * (tr + quad - m * d + logdet_k - logdet_s)


def elbo(
    p: SVGPParams, x, y, n_total, config: SVGPConfig, weights=None
) -> jnp.ndarray:
    """Minibatch ELBO estimate: the data term is scaled by n_total / batch
    (unbiased in expectation over uniformly drawn batches)."""
    b, d = y.shape
    scale = jnp.asarray(n_total, y.dtype) / b
    return scale * _data_term(p, x, y, weights, config) - _kl_qu(p, d, config)


def elbo_sharded(
    p: SVGPParams, x, y, config: SVGPConfig, *, mesh, weights=None,
    axis: Optional[str] = None,
) -> jnp.ndarray:
    """Exact full-data ELBO with (x, y, weights) sharded over the mesh and
    parameters replicated: the data term is a per-shard weighted sum psum'd
    over the mesh — the same one-collective MapReduce shape as the collapsed
    models (parallel/stats.py)."""
    from jax.sharding import PartitionSpec as PS

    from gparml.parallel.mesh import DATA_AXIS

    ax = axis or DATA_AXIS
    d = y.shape[1]
    w = jnp.ones((y.shape[0],), y.dtype) if weights is None else weights

    def body(p, xl, yl, wl):
        data = jax.lax.psum(_data_term(p, xl, yl, wl, config), ax)
        return data - _kl_qu(p, d, config)

    rep = PS()
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(jax.tree.map(lambda _: rep, p), PS(ax), PS(ax), PS(ax)),
        out_specs=rep,
        # KL is computed from replicated params (unvarying); the psum'd data
        # term is axis-invariant. Their sum trips the static varying-manual-
        # axes checker on some paths; replication is covered by the
        # mesh-{1,2,8} equivalence tests instead.
        check_vma=False,
    )(p, x, y, w)


def fit(
    p0: SVGPParams,
    x,
    y,
    config: SVGPConfig,
    steps: int = 1000,
    learning_rate: float = 1e-2,
    key=None,
    mesh=None,
    weights=None,
) -> FitResult:
    """Adam over minibatch ELBO estimates; one jit'd lax.scan.

    With ``mesh``, (x, y, weights) are globally sharded over the data axis
    (mesh_lib.shard_data / distributed.shard_data_multihost) and parameters
    replicated: each device draws its own wraparound window from ITS shard
    (disjoint per-device starts via fold_in(axis_index)), giving every real
    point inclusion probability batch/N exactly as in the single-device
    estimator; the per-step data term and its gradients reduce with one psum.
    batch_size is the GLOBAL batch (split evenly across devices)."""
    if mesh is not None:
        if config.layout == "qn":
            raise ValueError(
                "layout='qn' is the single-chip large-N affordance; the "
                "sharded path owns (N, Q) rows — use layout='nq'"
            )
        return _fit_sharded(
            p0, x, y, config, steps, learning_rate, key, mesh, weights
        )
    import optax

    # Under layout='qn' the resident dataset is (Q, N)/(D, N): the axis-1
    # window is still one dynamic_slice, and only the batch-sized window is
    # transposed into row-major form per step.
    n_ax = 1 if config.layout == "qn" else 0
    n = x.shape[n_ax]
    b = min(config.batch_size, n)
    key = jax.random.key(0) if key is None else key
    opt = optax.adam(learning_rate)
    mask = P.grad_mask(
        p0.glob, fixed_beta=config.fixed_beta, fixed_z=config.fixed_z,
        fixed_hypers=config.fixed_hypers,
    )
    # Pre-shuffle once; each step takes a random CONTIGUOUS window (a
    # dynamic_slice, far cheaper than an N-sized gather per step).
    # The window WRAPS AROUND via a one-time b-row extension so that start
    # can range over all n positions, giving every point inclusion
    # probability exactly b/n (a non-wraparound window is biased against
    # the array ends — see minibatch_window).
    key, kshuf = jax.random.split(key)
    perm = jax.random.permutation(kshuf, n)
    x = jnp.take(x, perm, axis=n_ax)
    y = jnp.take(y, perm, axis=n_ax)
    x_ext = extend_for_wraparound(x, b, axis=n_ax)
    y_ext = extend_for_wraparound(y, b, axis=n_ax)

    def window(a_ext, start):
        wb = minibatch_window(a_ext, start, b, axis=n_ax)
        return wb.T if n_ax == 1 else wb

    def step(carry, k):
        p, opt_state = carry
        start = jax.random.randint(k, (), 0, n)
        xb = window(x_ext, start)
        yb = window(y_ext, start)
        val, g = jax.value_and_grad(lambda pp: -elbo(pp, xb, yb, n, config))(p)
        g = p._replace(glob=P.apply_mask(g.glob, mask), q_mu=g.q_mu, q_sqrt=g.q_sqrt)
        updates, opt_state = opt.update(g, opt_state, p)
        p = optax.apply_updates(p, updates)
        return (p, opt_state), -val

    keys = jax.random.split(key, steps)
    (p, _), history = jax.lax.scan(step, (p0, opt.init(p0)), keys)
    # final ELBO report: full data if small, else an unbiased random subset
    # (FitResult.elbo_exact / .elbo_n make the estimator explicit)
    if n <= _EXACT_ELBO_MAX_N:
        xf = x.T if n_ax == 1 else x
        yf = y.T if n_ax == 1 else y
        final = elbo(p, xf, yf, n, config)
        elbo_exact, elbo_n = True, n
    else:
        # min(n, .): with 4*b >= n the "subset" is the full permutation —
        # report the true row count (and exactness) instead of 4*b
        n_sub = min(n, 4 * b)
        idx = jax.random.permutation(jax.random.key(1), n)[:n_sub]
        xf = jnp.take(x, idx, axis=n_ax)
        yf = jnp.take(y, idx, axis=n_ax)
        if n_ax == 1:
            xf, yf = xf.T, yf.T
        final = elbo(p, xf, yf, n, config)
        elbo_exact, elbo_n = (n_sub == n), n_sub
    return FitResult(params=p, elbo=final, history=history,
                     n_evals=jnp.asarray(steps, jnp.int32),
                     elbo_exact=elbo_exact, elbo_n=elbo_n)


def _fit_sharded(
    p0: SVGPParams, x, y, config: SVGPConfig, steps, learning_rate, key,
    mesh, weights,
) -> FitResult:
    """Data-parallel minibatch training (see fit docstring). The reference
    has no analogue (its only parallel mode is the collapsed full-data
    MapReduce); this extends its data-partitioning strategy to the streaming
    mode: partitions = device shards, partial sums = one psum per step."""
    import optax
    from jax.sharding import PartitionSpec as PS

    from gparml.parallel.mesh import DATA_AXIS

    ax = DATA_AXIS
    k_dev = mesh.shape[ax]
    n_pad, d = y.shape
    assert n_pad % k_dev == 0, "mesh_lib.shard_data pads N to the device count"
    n_local = n_pad // k_dev
    b_local = max(1, min(config.batch_size, n_pad) // k_dev)
    b_local = min(b_local, n_local)
    key = jax.random.key(0) if key is None else key
    opt = optax.adam(learning_rate)
    mask = P.grad_mask(
        p0.glob, fixed_beta=config.fixed_beta, fixed_z=config.fixed_z,
        fixed_hypers=config.fixed_hypers,
    )
    w = jnp.ones((n_pad,), y.dtype) if weights is None else weights
    # Inclusion probability of every local row is b_local / n_local, so the
    # unbiased scale is n_local / b_local per device (padded rows carry w=0
    # and contribute nothing; the psum then sums over devices).
    scale = jnp.asarray(n_local / b_local, y.dtype)
    rep = PS()
    p_specs = jax.tree.map(lambda _: rep, p0)

    # Per-shard shuffle + wraparound extension (one shard_map, outside the
    # scan): the shuffle decorrelates contiguous windows from any on-disk
    # row order (the single-device path shuffles globally once); the
    # b_local-row extension lets a window start anywhere in [0, n_local)
    # without a gather. One permutation per shard, folded by device index.
    key, kshuf = jax.random.split(key)

    def prep(x, y, w):
        kd = jax.random.fold_in(kshuf, jax.lax.axis_index(ax))
        perm = jax.random.permutation(kd, x.shape[0])
        out = []
        for a in (x, y, w):
            a = a[perm]
            out.append(jnp.concatenate([a, a[:b_local]], axis=0))
        return tuple(out)

    x_ext, y_ext, w_ext = jax.shard_map(
        prep, mesh=mesh, in_specs=(PS(ax),) * 3, out_specs=(PS(ax),) * 3,
        check_vma=False,
    )(x, y, w)

    def loss_body(p, k, xl, yl, wl):
        # disjoint per-device streams: fold the device index into the key
        kd = jax.random.fold_in(k, jax.lax.axis_index(ax))
        start = jax.random.randint(kd, (), 0, n_local)
        xb = minibatch_window(xl, start, b_local)
        yb = minibatch_window(yl, start, b_local)
        wb = minibatch_window(wl, start, b_local)
        data = jax.lax.psum(_data_term(p, xb, yb, wb, config), ax)
        return -(scale * data - _kl_qu(p, d, config))

    loss = jax.shard_map(
        loss_body, mesh=mesh,
        in_specs=(p_specs, rep, PS(ax), PS(ax), PS(ax)),
        out_specs=rep,
        check_vma=False,  # same policy as elbo_sharded
    )

    def step(carry, k, xe, ye, we):
        p, opt_state = carry
        val, g = jax.value_and_grad(lambda pp: loss(pp, k, xe, ye, we))(p)
        g = p._replace(glob=P.apply_mask(g.glob, mask), q_mu=g.q_mu,
                       q_sqrt=g.q_sqrt)
        updates, opt_state = opt.update(g, opt_state, p)
        p = optax.apply_updates(p, updates)
        return (p, opt_state), -val

    keys = jax.random.split(key, steps)
    # opt.init inside the jit (under multi-host it must build REPLICATED
    # state from the global params, not host-local eager zeros); the global
    # sharded data arrays ride as jit ARGUMENTS — closing over multi-host
    # arrays is not allowed.
    (p, _), history = jax.jit(
        lambda p0, keys, xe, ye, we: jax.lax.scan(
            lambda c, k: step(c, k, xe, ye, we), (p0, opt.init(p0)), keys
        )
    )(p0, keys, x_ext, y_ext, w_ext)
    # Final ELBO report, same policy as the plain path: full data if small,
    # else an unbiased subset estimate. (The full-data term at large N costs
    # O(N·M²·D) through the (D, M, B) projection, which would dwarf the
    # training steps at large N.) A prefix of
    # the per-shard SHUFFLED arrays is a uniform without-replacement sample,
    # and padded rows carry w=0, so the weighted prefix sum scaled by
    # n_local/l_sub estimates the full weighted data term exactly in
    # expectation.
    if n_pad <= _EXACT_ELBO_MAX_N:
        final = elbo_sharded(p, x, y, config, mesh=mesh, weights=weights)
        elbo_exact, elbo_n = True, n_pad
    else:
        l_sub = min(n_local, 4 * b_local)
        sub_scale = jnp.asarray(n_local / l_sub, y.dtype)

        def final_body(p, xl, yl, wl):
            data = jax.lax.psum(
                _data_term(p, xl[:l_sub], yl[:l_sub], wl[:l_sub], config), ax
            )
            return sub_scale * data - _kl_qu(p, d, config)

        final = jax.shard_map(
            final_body, mesh=mesh,
            in_specs=(p_specs, PS(ax), PS(ax), PS(ax)), out_specs=rep,
            check_vma=False,  # same policy as elbo_sharded
        )(p, x_ext, y_ext, w_ext)
        elbo_exact, elbo_n = False, l_sub * k_dev
    return FitResult(params=p, elbo=final, history=history,
                     n_evals=jnp.asarray(steps, jnp.int32),
                     elbo_exact=elbo_exact, elbo_n=elbo_n)


def predict(p: SVGPParams, x_star, config: SVGPConfig):
    """Predictive mean and variance (incl. noise) under q(u)."""
    z, sf2, alpha, beta = P.constrain(p.glob, config.bijector)
    kmm = ard_rbf.kmm(z, sf2, alpha, jitter=config.jitter)
    lm = jnp.linalg.cholesky(kmm)
    m = z.shape[0]
    lm_inv = solve_triangular(lm, jnp.eye(m, dtype=lm.dtype), lower=True)
    knm = ard_rbf.k(x_star, z, sf2, alpha)
    a = jnp.matmul(lm_inv, knm.T, precision="highest")
    mean = jnp.matmul(a.T, jnp.matmul(lm_inv, p.q_mu, precision="highest"),
                      precision="highest")
    knn = ard_rbf.k_diag(x_star, sf2)
    qnn = jnp.sum(a * a, axis=0)
    ls = _tril(p.q_sqrt)
    proj = jnp.einsum(
        "dmk,mb->dkb", ls, jnp.matmul(lm_inv.T, a, precision="highest"),
        precision="highest",
    )
    var_q = jnp.sum(proj * proj, axis=1).T
    var = (knn - qnn)[:, None] + var_q + 1.0 / beta
    return mean, var
