"""Parameter pytrees for the sparse-GP / GPLVM models.

The reference packs global params into one flat NumPy vector with log
transforms and keeps per-point variational params in files
(``parallel_GPLVM.py`` + ``local_MapReduce.py`` ``embeddings_*`` ops,
SURVEY.md §2-3). Here every parameter is a leaf of one pytree: globals are
small replicated arrays, latents are (N, Q) arrays that shard over the data
mesh axis — the file layer's role is played by sharding, and optimizers
operate on the whole pytree uniformly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gparml.utils import transforms


class GlobalParams(NamedTuple):
    """Replicated global parameters, unconstrained space."""

    z: jnp.ndarray        # (M, Q) inducing inputs
    u_sf2: jnp.ndarray    # () signal variance, bijector-space
    u_alpha: jnp.ndarray  # (Q,) ARD precisions, bijector-space
    u_beta: jnp.ndarray   # () noise precision, bijector-space


class LatentParams(NamedTuple):
    """Per-data-point variational parameters q(x_n)=N(mu_n, diag(s_n));
    sharded over the data axis.

    Leaves are (N, Q) in the default layout, or TRANSPOSED (Q, N) under
    ``layout='qn'`` (GPLVMConfig). The transposed layout is single-device
    only; the sharded path keeps (N, Q) rows (the shard axis)."""

    mu: jnp.ndarray       # (N, Q) — or (Q, N) under layout='qn'
    u_s: jnp.ndarray      # same layout; variances, bijector-space


class GPLVMParams(NamedTuple):
    glob: GlobalParams
    lat: LatentParams


def constrain(g: GlobalParams, bijector: str = "exp"):
    """Unconstrained GlobalParams -> (z, sf2, alpha, beta) in natural space."""
    bij = transforms.get(bijector)
    return g.z, bij.forward(g.u_sf2), bij.forward(g.u_alpha), bij.forward(g.u_beta)


def constrain_latents(l: LatentParams, bijector: str = "exp",
                      layout: str = "nq", native: bool = False):
    """Unconstrained LatentParams -> (mu, s) in natural space, returned
    (N, Q) by default (transposing out of the ``qn`` storage layout).
    ``native=True`` keeps the storage layout — the transposed path hands
    (Q, N) leaves straight to psi.suff_stats_t."""
    bij = transforms.get(bijector)
    mu, u_s = l.mu, l.u_s
    if layout == "qn" and not native:
        mu, u_s = mu.T, u_s.T
    return mu, bij.forward(u_s)


def make_global(z, sf2, alpha, beta, bijector: str = "exp") -> GlobalParams:
    """Build GlobalParams from natural-space values."""
    bij = transforms.get(bijector)
    z = jnp.asarray(z)
    return GlobalParams(
        z=z,
        u_sf2=bij.inverse(jnp.asarray(sf2, dtype=z.dtype)),
        u_alpha=bij.inverse(jnp.asarray(alpha, dtype=z.dtype)),
        u_beta=bij.inverse(jnp.asarray(beta, dtype=z.dtype)),
    )


def make_latents(mu, s, bijector: str = "exp",
                 layout: str = "nq") -> LatentParams:
    """Build LatentParams from natural-space (N, Q) values; stores leaves
    transposed when layout='qn' (see LatentParams). The qn transpose runs
    on HOST so only the (Q, N) form ever uploads."""
    bij = transforms.get(bijector)
    if layout == "qn":
        if isinstance(mu, jax.core.Tracer) or isinstance(s, jax.core.Tracer):
            mu, s = mu.T, s.T  # traced values must stay on device
        else:
            import numpy as _np
            mu = _np.ascontiguousarray(_np.asarray(mu).T)
            s = _np.ascontiguousarray(_np.asarray(s).T)
    mu = jnp.asarray(mu)
    u_s = bij.inverse(jnp.asarray(s, dtype=mu.dtype))
    return LatentParams(mu=mu, u_s=u_s)


def grad_mask(
    params,
    fixed_beta: bool = False,
    fixed_embeddings: bool = False,
    fixed_z: bool = False,
    fixed_hypers: bool = False,
):
    """0/1 pytree matching ``params`` that zeroes gradients of fixed leaves.

    Mirrors the reference's ``--fixed_beta`` / ``--fixed_embeddings`` options
    (SURVEY.md §5 config table [C-MED names]).
    """

    def mask_global(g: GlobalParams) -> GlobalParams:
        one = lambda a: jnp.ones_like(a)
        zero = lambda a: jnp.zeros_like(a)
        return GlobalParams(
            z=zero(g.z) if fixed_z else one(g.z),
            u_sf2=zero(g.u_sf2) if fixed_hypers else one(g.u_sf2),
            u_alpha=zero(g.u_alpha) if fixed_hypers else one(g.u_alpha),
            u_beta=zero(g.u_beta) if (fixed_beta or fixed_hypers) else one(g.u_beta),
        )

    if isinstance(params, GPLVMParams):
        lat_fn = jnp.zeros_like if fixed_embeddings else jnp.ones_like
        return GPLVMParams(
            glob=mask_global(params.glob),
            lat=jax.tree.map(lat_fn, params.lat),
        )
    return mask_global(params)


def apply_mask(grads, mask):
    return jax.tree.map(lambda g, m: g * m, grads, mask)


def tree_dot(a, b) -> jnp.ndarray:
    """Pytree inner product: sum over all leaves of <a_i, b_i>.

    Replaces the reference SCG's split in-memory + map-reduced-file inner
    products (``embeddings_get_grads_*``, SURVEY.md §3.3): sharded leaves
    contribute via sharded vdots that XLA reduces across devices automatically.
    """
    leaves = jax.tree.leaves(jax.tree.map(lambda x, y: jnp.vdot(x, y), a, b))
    return sum(leaves[1:], leaves[0])


def tree_axpy(alpha, x, y):
    """y + alpha * x, leafwise."""
    return jax.tree.map(lambda xi, yi: yi + alpha * xi, x, y)


def tree_scale(alpha, x):
    return jax.tree.map(lambda xi: alpha * xi, x)


def tree_neg(x):
    return jax.tree.map(jnp.negative, x)
