"""Initialization helpers: PCA embedding init and inducing-point selection.

Re-design of GParML's init path (``parallel_GPLVM.py`` --init PCA and
``supporting_functions.py`` PCA [C-MED], SURVEY.md §3.5): the reference maps
a per-partition (or two-pass global) PCA over partition files; here the
covariance accumulation is a single (D, D) gram matrix — a plain sum over
data points, so under a data-sharded ``jit`` XLA reduces it across devices
automatically (the distributed two-pass PCA falls out for free).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pca(y: jnp.ndarray, q: int) -> jnp.ndarray:
    """Project Y (N, D) onto its top-q principal components, scaled to unit
    variance per retained component (the conventional GPLVM latent init)."""
    yc = y - jnp.mean(y, axis=0, keepdims=True)
    # (D, D) gram — a sum over n, shardable; eigh of a small matrix.
    cov = (yc.T @ yc) / y.shape[0]
    evals, evecs = jnp.linalg.eigh(cov)
    # eigh returns ascending order; take the top q.
    top = evecs[:, -q:][:, ::-1]
    top_vals = evals[-q:][::-1]
    x = yc @ top
    return x / jnp.sqrt(jnp.maximum(top_vals, 1e-12))


def host_candidate_rows(x_np, m: int, seed: int = 0, factor: int = 16,
                        floor: int = 4096):
    """Host-side (numpy) candidate subset for :func:`init_inducing`.

    Uniformly samples at most ``max(factor*m, floor)`` rows with plain numpy
    indexing so only the compact (C, Q) candidate block is ever uploaded,
    never the whole (N, Q) array. FPS over a uniform candidate set
    this much larger than M still yields well-separated inducing points.
    """
    import numpy as np

    n = x_np.shape[0]
    c = min(n, max(factor * m, floor))
    if c >= n:
        return np.ascontiguousarray(x_np)
    idx = np.sort(np.random.default_rng(seed).choice(n, size=c, replace=False))
    return np.ascontiguousarray(x_np[idx])


def init_latents(key, y: jnp.ndarray, q: int, method: str = "pca", s0: float = 0.5):
    """Initial (mu, s) for the GPLVM: PCA or random projections, s = s0.

    Matches the reference's defaults: PCA means, constant ~0.5 variances
    (SURVEY.md §3.5 [C-MED]).
    """
    if method == "pca":
        mu = pca(y, q)
    elif method == "random":
        mu = jax.random.normal(key, (y.shape[0], q), dtype=y.dtype)
    else:
        raise ValueError(f"unknown init method {method!r}; options: pca, random")
    s = jnp.full((y.shape[0], q), s0, dtype=y.dtype)
    return mu, s


def init_inducing(
    key, x: jnp.ndarray, m: int, noise: float = 1e-2, method: str = "fps"
) -> jnp.ndarray:
    """M inducing inputs from the data (reference: "Z <- M rows sampled from
    embeddings (+jitter)", SURVEY.md §3.1).

    Default is farthest-point sampling rather than the reference's uniform
    rows: uniform sampling of dense data picks near-duplicate rows whose
    K_MM condition number exceeds float32 (the reference ran float64 CPU and
    never hit this). FPS keeps the Gram matrix Cholesky-safe by construction;
    a small data-scaled jitter is still added, matching the reference.
    """
    n = x.shape[0]
    k1, k2 = jax.random.split(key)
    if method == "random" or m > n:
        idx = (
            jax.random.choice(k1, n, shape=(m,), replace=False)
            if m <= n
            else jax.random.randint(k1, (m,), 0, n)
        )
        z = x[idx]
    else:
        # farthest-point sampling: O(N*M), fully jittable
        i0 = jax.random.randint(k1, (), 0, n)

        def step(mind, _):
            i = jnp.argmax(mind)
            d2 = jnp.sum((x - x[i]) ** 2, axis=-1)
            return jnp.minimum(mind, d2), i

        d2_0 = jnp.sum((x - x[i0]) ** 2, axis=-1)
        _, rest = jax.lax.scan(step, d2_0, None, length=m - 1)
        idx = jnp.concatenate([i0[None], rest])
        z = x[idx]
    scale = noise * jnp.maximum(jnp.std(x, axis=0), 1e-6)
    return z + scale * jax.random.normal(k2, z.shape, dtype=x.dtype)
