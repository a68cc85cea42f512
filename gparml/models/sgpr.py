"""Sparse variational GP regression (Titsias 2009) — the reference's
``--fixed_embeddings`` mode (SURVEY.md §3.2): inputs X observed, s ≡ 0,
psi-statistics collapse to plain kernel products (Psi1 = K_NM,
Psi2 = K_NM^T K_NM are plain matrix products), KL(q(X)) vanishes, and the
parameter vector holds only globals (Z, kernel hypers, noise precision)."""

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
class SGPRConfig:
    num_inducing: int = 10
    bijector: str = "exp"
    jitter: float = 1e-6
    block: Optional[int] = None      # N-block size for the scanned psi path
    layout: str = "nq"               # 'qn': x is (Q, N), y is (D, N);
                                     # single-device only
    fixed_beta: bool = False         # reference --fixed_beta
    fixed_z: bool = False
    fixed_hypers: bool = False
    scg_mode: str = "auto"           # 'fused' | 'stepped' | 'auto' — see
                                     # gplvm.GPLVMConfig.scg_mode


class FitResult(NamedTuple):
    params: P.GlobalParams
    bound: jnp.ndarray          # final evidence lower bound (maximized)
    history: jnp.ndarray        # per-iteration bound values
    n_evals: jnp.ndarray
    trace: Optional[dict] = None  # SCG per-iteration {bound, gnorm2, lambda, alpha, accepted}


def scg_trace(st) -> dict:
    """Bound-sign per-iteration observability dict from a final SCGState
    (the reference's display columns: SURVEY.md §5 metrics row)."""
    return {
        "bound": -st.history.f,
        "gnorm2": st.history.gnorm2,
        "lambda": st.history.lam,
        "alpha": st.history.alpha,
        "accepted": st.history.accepted,
    }


def init_params(
    key,
    x: jnp.ndarray,
    y: jnp.ndarray,
    config: SGPRConfig,
    sf2: Optional[float] = None,
    alpha=None,
    beta: Optional[float] = None,
) -> P.GlobalParams:
    """Data-driven defaults: Z = random rows of X, sf2 = var(Y),
    alpha = 1/var(X_q), beta = 10/var(Y). Under layout='qn' the init's
    row-major view of X is a one-time transient (truly-huge-N users pass
    Z / hypers explicitly)."""
    x_rows = x.T if config.layout == "qn" else x
    z = init_utils.init_inducing(key, x_rows, config.num_inducing)
    var_y = jnp.maximum(jnp.var(y), 1e-6)
    if sf2 is None:
        sf2 = var_y
    if alpha is None:
        alpha = 1.0 / jnp.maximum(jnp.var(x_rows, axis=0), 1e-6)
    if beta is None:
        beta = 10.0 / var_y
    return P.make_global(z, sf2, alpha, beta, bijector=config.bijector)


def _stats(g, x, y, config: SGPRConfig, mesh=None, weights=None):
    z, sf2, alpha, _ = P.constrain(g, config.bijector)
    if config.layout == "qn":
        if mesh is not None:
            raise ValueError(
                "layout='qn' is the single-chip large-N affordance; the "
                "sharded path owns (N, Q) rows — use layout='nq'"
            )
        return psi.suff_stats_t(
            y, x, None, z, sf2, alpha, block=config.block, weights=weights
        )
    return suff_stats_auto(
        y, x, None, z, sf2, alpha, mesh=mesh, block=config.block, weights=weights
    )


def suff_stats(
    g: P.GlobalParams, x, y, config: SGPRConfig, mesh=None, weights=None
) -> psi.SufficientStats:
    return _stats(g, x, y, config, mesh=mesh, weights=weights)


def log_bound(
    g: P.GlobalParams, x, y, config: SGPRConfig, mesh=None, weights=None
) -> jnp.ndarray:
    """Evidence lower bound F (to maximize). With ``mesh``, (x, y, weights)
    are sharded over the data axis and the statistics psum over the mesh."""
    z, sf2, alpha, beta = P.constrain(g, config.bijector)
    stats = _stats(g, x, y, config, mesh=mesh, weights=weights)
    d = y.shape[0] if config.layout == "qn" else y.shape[1]
    return bound_ops.bound_from_stats(
        stats, z, sf2, alpha, beta, d=d, jitter=config.jitter
    )


def neg_bound_value_and_grad(
    g, x, y, config: SGPRConfig, mask=None, mesh=None, weights=None
):
    """(-F, masked grad) — the SCG objective. One fused pass replaces the
    reference's likelihood_and_gradient MapReduce round (SURVEY.md §3.1)."""
    f, grad = jax.value_and_grad(
        lambda gg: -log_bound(gg, x, y, config, mesh=mesh, weights=weights)
    )(g)
    if mask is not None:
        grad = P.apply_mask(grad, mask)
    return f, grad


def fit(
    g0: P.GlobalParams,
    x: jnp.ndarray,
    y: jnp.ndarray,
    config: SGPRConfig,
    iters: int = 100,
    optimizer: str = "scg",
    learning_rate: float = 1e-2,
    scg_options: Optional[scg.SCGOptions] = None,
    mesh=None,
    weights=None,
) -> FitResult:
    """Maximize the bound with SCG (default, matching the reference) or an
    optax rule. The whole optimization is one jit'd computation."""
    if y.ndim != 2 or x.ndim != 2:
        raise ValueError(f"X, Y must be 2-D; got {x.shape}, {y.shape}")
    n_ax, q_ax = (1, 0) if config.layout == "qn" else (0, 1)
    if x.shape[n_ax] != y.shape[n_ax]:
        raise ValueError(
            f"X has N={x.shape[n_ax]} but Y has N={y.shape[n_ax]} "
            f"(layout {config.layout!r})")
    if g0.z.shape[1] != x.shape[q_ax]:
        raise ValueError(f"Z dim {g0.z.shape[1]} != X dim {x.shape[q_ax]}")
    mask = P.grad_mask(
        g0, fixed_beta=config.fixed_beta, fixed_z=config.fixed_z,
        fixed_hypers=config.fixed_hypers,
    )

    # Data AND the gradient mask ride as jit ARGUMENTS (not closure
    # constants): a multi-host global array cannot be embedded as a
    # compile-time constant.
    def vg_of(x, y, weights, mask):
        return lambda g: neg_bound_value_and_grad(
            g, x, y, config, mask, mesh=mesh, weights=weights
        )

    if optimizer == "scg":
        opts = scg_options or scg.SCGOptions(max_iters=iters)
        # true budget as a runtime scalar, bucketed history: one compiled
        # program across different -T (see gplvm.fit / scg.bucket_iters)
        limit = opts.max_iters
        opts = opts._replace(max_iters=scg.bucket_iters(limit))
        if scg.use_stepped(config.scg_mode, x.shape[n_ax]):
            st = scg.minimize_stepped(
                lambda g, xx, yy, w, m: vg_of(xx, yy, w, m)(g), g0, opts,
                extra=(x, y, weights, mask), iter_limit=limit)
        else:
            st = jax.jit(
                lambda g, x, y, w, m, il: scg.minimize(
                    vg_of(x, y, w, m), g, opts, iter_limit=il)
            )(g0, x, y, weights, mask, jnp.int32(limit))
        return FitResult(st.x, -st.f_now, -st.history.f, st.n_evals, scg_trace(st))
    elif optimizer in ("adam", "gd"):
        import optax
        rule = optax.adam(learning_rate) if optimizer == "adam" else optax.sgd(learning_rate)
        res = jax.jit(
            lambda g, x, y, w, m: optax_adapter.minimize(
                vg_of(x, y, w, m), g, iters, optimizer=rule
            )
        )(g0, x, y, weights, mask)
        return FitResult(res.x, -res.f_now, -res.history, res.n_evals)
    raise ValueError(f"unknown optimizer {optimizer!r}; options: scg, adam, gd")


def predict(g: P.GlobalParams, x, y, x_star, config: SGPRConfig, mesh=None, weights=None):
    """Predictive mean and variance (incl. noise) at x_star."""
    z, sf2, alpha, beta = P.constrain(g, config.bijector)
    stats = _stats(g, x, y, config, mesh=mesh, weights=weights)
    return bound_ops.predict(x_star, stats, z, sf2, alpha, beta, jitter=config.jitter)
