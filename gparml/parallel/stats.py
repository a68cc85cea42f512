"""Data-parallel sufficient statistics: shard_map + psum over the mesh.

This module *is* the reference's MapReduce layer, re-designed for a device
mesh (GParML ``local_MapReduce.py`` / remote twin, SURVEY.md §2 [C-HIGH]):

  reference                              | here
  ---------------------------------------+--------------------------------
  map: one OS process per partition      | shard_map body on each device
  computes per-partition psi statistics  | computes per-shard SufficientStats
  writes partial-stat .npy files to tmp/ | (stays in device memory)
  reduce: sum partial files on master    | one psum over the mesh
  statistics caching keyed on params     | unnecessary: value_and_grad is one
  (SCG probes re-evaluate same x)        | fused pass under jit

One psum of (M² + M·D + 4) floats per bound+grad evaluation replaces
thousands of file writes. Gradients flow through the psum (its transpose is
the identity broadcast), so jax.grad of the distributed bound is exact.

The psi engine is chosen here, from the platform and the dtype
(``choose_engine``): the fused Pallas kernels of ``ops/psi_gpu.py`` for
float32 on a GPU, the blocked XLA scan of ``ops/psi.py`` otherwise.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from gparml.ops import psi, psi_gpu
from gparml.parallel.mesh import DATA_AXIS

ENGINES = ("auto", "xla", "gpu")


def choose_engine(requested: str, dtype, latent: bool = True,
                  platform: Optional[str] = None) -> str:
    """The psi engine that runs: 'gpu' (fused kernels) or 'xla' (scan).

    'auto' takes the kernels for float32 GPLVM statistics on a GPU and the
    XLA scan for everything else: float64 (the reference engine) and the
    SGPR statistics (``latent=False``: K_NM products, which XLA runs as
    plain matrix products). An explicit 'gpu' off the GPU, or with another
    dtype, is an error — it never falls back to the Pallas interpreter."""
    if requested not in ENGINES:
        raise ValueError(f"unknown psi engine {requested!r}; options: {ENGINES}")
    platform = platform or jax.default_backend()
    f32 = jnp.dtype(dtype) == jnp.float32
    if requested == "auto":
        return "gpu" if platform == "gpu" and f32 and latent else "xla"
    if requested == "gpu":
        if platform != "gpu":
            raise ValueError(
                f"stats_impl='gpu' needs a GPU; this process runs on "
                f"{platform!r} (use 'auto' or 'xla')")
        if not f32:
            raise ValueError(
                f"stats_impl='gpu' computes in float32; {jnp.dtype(dtype)} "
                "runs the XLA scan (use 'auto' or 'xla')")
    return requested


def _local_stats(y, mu, s, z, sf2, alpha, block, weights, engine,
                 vary_axis=None):
    if engine == "gpu" and s is not None:
        return psi_gpu.suff_stats(y, mu, s, z, sf2, alpha, weights=weights,
                                  vary_axis=vary_axis)
    return psi.suff_stats(y, mu, s, z, sf2, alpha, block=block, weights=weights,
                          vary_axis=vary_axis)


def suff_stats_sharded(
    y,
    mu,
    s,
    z,
    sf2,
    alpha,
    *,
    mesh: Mesh,
    axis: str = DATA_AXIS,
    block: Optional[int] = None,
    weights=None,
    impl: str = "auto",
) -> psi.SufficientStats:
    """Global SufficientStats with (y, mu, s, weights) sharded over ``axis``
    and (z, sf2, alpha) replicated. Output is replicated on every device.

    Differentiable: cotangents wrt the replicated params are psum-reduced by
    shard_map's transpose, exactly mirroring the reference's summed partial
    gradients (SURVEY.md §3.4).
    """
    has_s = s is not None
    has_w = weights is not None
    engine = choose_engine(impl, mu.dtype, latent=has_s)

    def local(y, mu, s_or_none, w_or_none, z, sf2, alpha):
        st = _local_stats(
            y, mu, s_or_none, z, sf2, alpha, block, w_or_none, engine,
            vary_axis=axis,
        )
        return jax.tree.map(lambda t: jax.lax.psum(t, axis), st)

    # Keep the arg list static per (has_s, has_w) combination so specs match.
    sharded = P(axis)
    rep = P()

    def wrapped(y, mu, s_, w_, z, sf2, alpha):
        return local(
            y, mu, s_ if has_s else None, w_ if has_w else None, z, sf2, alpha
        )

    dummy_s = s if has_s else mu  # placeholder with a valid sharding
    dummy_w = weights if has_w else y[:, 0]

    fn = jax.shard_map(
        wrapped,
        mesh=mesh,
        in_specs=(sharded, sharded, sharded, sharded, rep, rep, rep),
        out_specs=rep,
        # The varying-manual-axes checker stays on for both engines: the
        # scan's zero init is pcast to varying (psi.suff_stats) and the
        # kernels declare their outputs' vma (psi_gpu._call).
        check_vma=True,
    )
    return fn(y, mu, dummy_s, dummy_w, z, sf2, alpha)


def suff_stats_auto(
    y, mu, s, z, sf2, alpha,
    *, mesh: Optional[Mesh] = None, axis: str = DATA_AXIS,
    block: Optional[int] = None, weights=None, impl: str = "auto",
) -> psi.SufficientStats:
    """Single-device or distributed sufficient statistics, one entry point.

    ``mesh=None`` is the reference's single-worker path; a mesh switches to
    shard_map+psum (its ``-p local`` vs cluster backends collapse to this one
    flag, SURVEY.md §2 "Remote/cluster MapReduce backend"). ``impl`` requests
    the psi engine ('auto', 'xla' or 'gpu'; see choose_engine)."""
    if mesh is None:
        engine = choose_engine(impl, mu.dtype, latent=s is not None)
        return _local_stats(y, mu, s, z, sf2, alpha, block, weights, engine)
    return suff_stats_sharded(
        y, mu, s, z, sf2, alpha, mesh=mesh, axis=axis, block=block,
        weights=weights, impl=impl,
    )
