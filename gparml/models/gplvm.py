"""Bayesian GPLVM (Titsias & Lawrence 2010) with variational q(X) —
the reference's flagship model (``parallel_GPLVM.py`` main path,
SURVEY.md §3.1): latents X get a factorized Gaussian posterior
q(x_n) = N(mu_n, diag(s_n)) whose parameters are optimized jointly with the
globals. Where the reference keeps (mu_n, s_n) in per-partition files driven
by the SCG ``embeddings_*`` file ops, here they are (N, Q) leaves of the
parameter pytree that shard over the data mesh axis."""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from gparml.models import params as P
from gparml.ops import bound as bound_ops
from gparml.ops import psi
from gparml.opt import optax_adapter, scg
from gparml.parallel.stats import suff_stats_auto
from gparml.utils import init as init_utils


@dataclass(frozen=True)
class GPLVMConfig:
    q: int = 2                       # latent dimensionality (reference -q)
    num_inducing: int = 10           # reference -m
    bijector: str = "exp"
    jitter: float = 1e-6
    block: Optional[int] = None      # scan rows per step (None: derived
                                     # from N, M, dtype — psi.derive_block)
    stats_impl: str = "auto"         # psi engine: auto | xla | gpu
                                     # (parallel.stats.choose_engine)
    init: str = "pca"                # reference --init {PCA, random}
    layout: str = "nq"               # latent storage: 'nq' (N, Q) | 'qn'
                                     # transposed (Q, N); single-device only
                                     # — see params.LatentParams
    y_layout: str = "nd"             # observation layout: 'nd' (N, D) | 'dn'
                                     # transposed (D, N) — pairs with 'qn'
    s0: float = 0.5                  # initial variational variance
    fixed_embeddings: bool = False   # reference --fixed_embeddings
    fixed_beta: bool = False         # reference --fixed_beta
    fixed_z: bool = False
    fixed_hypers: bool = False
    scg_mode: str = "auto"           # SCG driver: 'fused' (one while_loop
                                     # program for the whole fit) | 'stepped'
                                     # (one program per iteration, host loop)
                                     # | 'auto' (stepped at/above
                                     # scg.STEPPED_N_THRESHOLD rows)


class FitResult(NamedTuple):
    params: P.GPLVMParams
    bound: jnp.ndarray
    history: jnp.ndarray
    n_evals: jnp.ndarray
    trace: Optional[dict] = None  # SCG per-iteration {bound, gnorm2, lambda, alpha, accepted}


def init_params(
    key,
    y: jnp.ndarray,
    config: GPLVMConfig,
    sf2: float = 1.0,
    alpha=None,
    beta: Optional[float] = None,
) -> P.GPLVMParams:
    """PCA (or random) latent init; Z sampled from the initialized latents;
    hypers default to sf2=1, alpha=1, beta=10/var(Y) (reference defaults,
    SURVEY.md §3.1/§3.5 [C-MED])."""
    k1, k2 = jax.random.split(key)
    if (config.y_layout == "dn" and config.layout == "qn"
            and config.init == "random"):
        # Fully (Q, N)-native init: random latents are N(0, 1), so Z can be
        # sampled from the same distribution directly — no (N, Q) row-major
        # array ever exists, even transiently.
        from gparml.utils import transforms
        n = y.shape[1]
        dtype = y.dtype
        mu_t = jax.random.normal(k1, (config.q, n), dtype=dtype)
        bij = transforms.get(config.bijector)
        u_s_t = bij.inverse(jnp.full((config.q, n), config.s0, dtype=dtype))
        k2a, k2b = jax.random.split(k2)
        z = jax.random.normal(k2a, (config.num_inducing, config.q), dtype)
        z = z + 1e-2 * jax.random.normal(k2b, z.shape, dtype)
        if alpha is None:
            alpha = jnp.ones((config.q,), dtype=dtype)
        if beta is None:
            beta = 10.0 / jnp.maximum(jnp.var(y), 1e-6)
        glob = P.make_global(z, sf2, alpha, beta, bijector=config.bijector)
        return P.GPLVMParams(
            glob=glob, lat=P.LatentParams(mu=mu_t, u_s=u_s_t))
    if config.y_layout == "dn":
        y = y.T  # init math is row-major (PCA / var); one-time, outside jit
    mu, s = init_utils.init_latents(k1, y, config.q, method=config.init, s0=config.s0)
    z = init_utils.init_inducing(k2, mu, config.num_inducing)
    if alpha is None:
        alpha = jnp.ones((config.q,), dtype=y.dtype)
    if beta is None:
        beta = 10.0 / jnp.maximum(jnp.var(y), 1e-6)
    glob = P.make_global(z, sf2, alpha, beta, bijector=config.bijector)
    lat = P.make_latents(mu, s, bijector=config.bijector, layout=config.layout)
    return P.GPLVMParams(glob=glob, lat=lat)


def _d_of(y, config: GPLVMConfig) -> int:
    return y.shape[0] if config.y_layout == "dn" else y.shape[1]


def _stats(p: P.GPLVMParams, y, config: GPLVMConfig, mesh=None, weights=None):
    z, sf2, alpha, _ = P.constrain(p.glob, config.bijector)
    if config.layout == "qn" and mesh is None:
        # the transposed blocked scan: per-block slab transposes, never a
        # whole-array relayout into (N, Q) form
        mu_t, s_t = P.constrain_latents(
            p.lat, config.bijector, "qn", native=True)
        y_t = y if config.y_layout == "dn" else y.T
        return psi.suff_stats_t(
            y_t, mu_t, s_t, z, sf2, alpha, block=config.block,
            weights=weights)
    mu, s = P.constrain_latents(p.lat, config.bijector, config.layout)
    y_nd = y.T if config.y_layout == "dn" else y
    return suff_stats_auto(
        y_nd, mu, s, z, sf2, alpha, mesh=mesh, block=config.block,
        weights=weights, impl=config.stats_impl,
    )


def suff_stats(
    p: P.GPLVMParams, y, config: GPLVMConfig, mesh=None, weights=None
) -> psi.SufficientStats:
    return _stats(p, y, config, mesh=mesh, weights=weights)


def log_bound(p: P.GPLVMParams, y, config: GPLVMConfig, mesh=None, weights=None) -> jnp.ndarray:
    """Evidence lower bound. With ``mesh``, y/weights and the latent leaves
    of ``p`` are sharded over the data axis (the reference's partitions)."""
    z, sf2, alpha, beta = P.constrain(p.glob, config.bijector)
    stats = _stats(p, y, config, mesh=mesh, weights=weights)
    return bound_ops.bound_from_stats(
        stats, z, sf2, alpha, beta, d=_d_of(y, config), jitter=config.jitter
    )


def neg_bound_value_and_grad(p, y, config: GPLVMConfig, mask=None, mesh=None, weights=None):
    f, grad = jax.value_and_grad(
        lambda pp: -log_bound(pp, y, config, mesh=mesh, weights=weights)
    )(p)
    if mask is not None:
        grad = P.apply_mask(grad, mask)
    return f, grad


def _check(p: P.GPLVMParams, y, config: GPLVMConfig):
    if y.ndim != 2:
        raise ValueError(f"Y must be 2-D; got {y.shape}")
    if config.layout == "qn":
        q, n = p.lat.mu.shape
    else:
        n, q = p.lat.mu.shape
    y_n = y.shape[1] if config.y_layout == "dn" else y.shape[0]
    if y_n != n:
        raise ValueError(
            f"Y has N={y_n} (layout {config.y_layout!r}) but latents have "
            f"N={n} (shard_data pads both together; pass matching arrays)"
        )
    if q != config.q:
        raise ValueError(f"latents have Q={q} but config.q={config.q}")
    if p.glob.z.shape != (config.num_inducing, config.q):
        raise ValueError(
            f"Z has shape {p.glob.z.shape}, expected "
            f"({config.num_inducing}, {config.q})"
        )


def fit(
    p0: P.GPLVMParams,
    y: jnp.ndarray,
    config: GPLVMConfig,
    iters: int = 100,
    optimizer: str = "scg",
    learning_rate: float = 1e-2,
    scg_options: Optional[scg.SCGOptions] = None,
    mesh=None,
    weights=None,
) -> FitResult:
    _check(p0, y, config)
    if mesh is not None and config.layout == "qn":
        raise ValueError(
            "layout='qn' is the single-chip large-N affordance; under a "
            "mesh the latents shard over (N, Q) rows — use layout='nq'"
        )
    mask = P.grad_mask(
        p0,
        fixed_beta=config.fixed_beta,
        fixed_embeddings=config.fixed_embeddings,
        fixed_z=config.fixed_z,
        fixed_hypers=config.fixed_hypers,
    )

    # Data AND the gradient mask ride as jit ARGUMENTS (not closure
    # constants): multi-host global arrays — the sharded Y/weights and the
    # mask's ones_like of the sharded latents — cannot be embedded as
    # compile-time constants.
    def vg_of(y, weights, mask):
        return lambda p: neg_bound_value_and_grad(
            p, y, config, mask, mesh=mesh, weights=weights
        )

    if optimizer == "scg":
        opts = scg_options or scg.SCGOptions(max_iters=iters)
        # The true iteration budget rides as a RUNTIME scalar; max_iters is
        # bucketed so different -T values produce one compiled program
        # (a persistent-cache hit: a resume with a new T does not recompile
        # the whole fused fit).
        limit = opts.max_iters
        opts = opts._replace(max_iters=scg.bucket_iters(limit))
        n_rows = (p0.lat.mu.shape[1] if config.layout == "qn"
                  else p0.lat.mu.shape[0])
        if scg.use_stepped(config.scg_mode, n_rows):
            st = scg.minimize_stepped(
                lambda p, yy, w, m: vg_of(yy, w, m)(p), p0, opts,
                extra=(y, weights, mask), iter_limit=limit)
        else:
            st = jax.jit(
                lambda p, y, w, m, il: scg.minimize(
                    vg_of(y, w, m), p, opts, iter_limit=il)
            )(p0, y, weights, mask, jnp.int32(limit))
        from gparml.models.sgpr import scg_trace
        return FitResult(st.x, -st.f_now, -st.history.f, st.n_evals, scg_trace(st))
    elif optimizer in ("adam", "gd"):
        import optax
        rule = optax.adam(learning_rate) if optimizer == "adam" else optax.sgd(learning_rate)
        res = jax.jit(
            lambda p, y, w, m: optax_adapter.minimize(
                vg_of(y, w, m), p, iters, optimizer=rule
            )
        )(p0, y, weights, mask)
        return FitResult(res.x, -res.f_now, -res.history, res.n_evals)
    raise ValueError(f"unknown optimizer {optimizer!r}; options: scg, adam, gd")


def predict_observed(p: P.GPLVMParams, y, x_star, config: GPLVMConfig, mesh=None, weights=None):
    """Predictive p(y* | x*) at given latent locations x_star."""
    z, sf2, alpha, beta = P.constrain(p.glob, config.bijector)
    stats = _stats(p, y, config, mesh=mesh, weights=weights)
    return bound_ops.predict(x_star, stats, z, sf2, alpha, beta, jitter=config.jitter)


def latents(p: P.GPLVMParams, config: GPLVMConfig):
    """The learned latent embedding (mu, s) in natural space."""
    return P.constrain_latents(p.lat, config.bijector, config.layout)


def infer_latents(
    p: P.GPLVMParams,
    y_train,
    y_new,
    config: GPLVMConfig,
    iters: int = 100,
    mesh=None,
    weights=None,
    scg_options=None,
):
    """Variational latent inference for NEW observations y_new (N*, D):
    optimize q(x*) = N(mu*, diag(s*)) against the collapsed bound of the
    joint [train + test] data with every trained parameter held fixed —
    the Bayesian-GPLVM analogue of "predict the latent coordinates".

    Initialization: each test point starts at the latent mean of its nearest
    training point in data space. Returns (mu*, s*, FitResult-like history).
    """
    from gparml.opt import scg as scg_mod

    z, sf2, alpha, beta = P.constrain(p.glob, config.bijector)
    stats_train = suff_stats(p, y_train, config, mesh=mesh, weights=weights)
    stats_train = jax.tree.map(jax.lax.stop_gradient, stats_train)
    # the nn-init / new-point math below runs row-major; y_new is small
    if config.y_layout == "dn":
        y_train, y_new = y_train.T, y_new.T
    d = y_new.shape[1]

    # nearest-training-point init in data space
    mu_tr, _ = P.constrain_latents(p.lat, config.bijector, config.layout)
    d2 = (
        jnp.sum(y_new * y_new, axis=1)[:, None]
        - 2.0 * jnp.matmul(y_new, y_train.T, precision="highest")
        + jnp.sum(y_train * y_train, axis=1)[None, :]
    )
    nn = jnp.argmin(d2, axis=1)
    mu0 = mu_tr[nn]
    s0 = jnp.full_like(mu0, config.s0)
    lat0 = P.make_latents(mu0, s0, bijector=config.bijector, layout=config.layout)

    # y_new rides as a jit ARGUMENT, never a closure constant: an O(N*)
    # constant would be embedded in the compiled program.
    def neg_bound(lat, y_new):
        mu_s, s_s = P.constrain_latents(lat, config.bijector, config.layout)
        st_new = psi.suff_stats(y_new, mu_s, s_s, z, sf2, alpha, block=config.block)
        st = stats_train + st_new
        return -bound_ops.bound_from_stats(
            st, z, sf2, alpha, beta, d=d, jitter=config.jitter
        )

    vg_fn = jax.value_and_grad(neg_bound)
    opts = scg_options or scg_mod.SCGOptions(max_iters=iters)
    limit = opts.max_iters
    opts = opts._replace(max_iters=scg_mod.bucket_iters(limit))
    if scg_mod.use_stepped(config.scg_mode, y_new.shape[0]):
        st = scg_mod.minimize_stepped(vg_fn, lat0, opts, extra=(y_new,),
                                      iter_limit=limit)
    else:
        st = jax.jit(
            lambda l, yn, il: scg_mod.minimize(
                lambda ll: vg_fn(ll, yn), l, opts, iter_limit=il)
        )(lat0, y_new, jnp.int32(limit))
    mu_s, s_s = P.constrain_latents(st.x, config.bijector, config.layout)
    from gparml.models.sgpr import scg_trace
    return mu_s, s_s, FitResult(
        params=p, bound=-st.f_now, history=-st.history.f, n_evals=st.n_evals,
        trace=scg_trace(st),
    )


def reconstruct(p: P.GPLVMParams, y_train, mu_star, s_star, config: GPLVMConfig,
                mesh=None, weights=None, block: int = 1024):
    """Predictive mean/variance of y* given uncertain latents q(x*)
    (Bayesian-GPLVM reconstruction through the Psi1 expectations).
    ``block`` bounds the variance computation's working set to
    O(block*M^2) regardless of N* (ops/bound.predict_uncertain)."""
    z, sf2, alpha, beta = P.constrain(p.glob, config.bijector)
    stats = suff_stats(p, y_train, config, mesh=mesh, weights=weights)
    return bound_ops.predict_uncertain(
        mu_star, s_star, stats, z, sf2, alpha, beta, jitter=config.jitter,
        block=block,
    )
