"""Bayesian GPLVM on an oil-flow-style dataset (BASELINE config 2: N=1k,
D=12, Q=10, M=50, SCG to convergence).

The model must discover that ~2 latent dimensions suffice (ARD pruning) and
separate the three classes in latent space — the reference's flagship
experiment, evaluated here by nearest-neighbor classification accuracy in the
learned latent means.

    python examples/gplvm_oil_flow.py
"""

import sys
import os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
jax.config.update("jax_enable_x64", True)  # CPU demo: float64, like the reference
import jax.numpy as jnp

from gparml import data
from gparml.utils import compile_cache
from gparml.models import gplvm
from gparml.models import params as P


def knn_accuracy(x, labels):
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return float((labels[d2.argmin(1)] == labels).mean())

compile_cache.enable()


def main():
    y_np, labels = data.oil_flow_like(n=1000, d=12, seed=0)
    y = jnp.asarray(y_np)

    cfg = gplvm.GPLVMConfig(q=10, num_inducing=50)
    p0 = gplvm.init_params(jax.random.key(0), y, cfg)
    res = gplvm.fit(p0, y, cfg, iters=300)

    hist = np.asarray(res.history)
    hist = hist[np.isfinite(hist)]
    print(f"bound: {hist[0]:.1f} -> {hist[-1]:.1f} "
          f"({int(res.n_evals)} objective evaluations)")

    _, _, alpha, _ = P.constrain(res.params.glob)
    alpha = np.asarray(alpha)
    active = np.sort(alpha)[::-1]
    print("ARD precisions (sorted):", np.array2string(active, precision=4))
    print(f"effective latent dims (alpha > 1% of max): {(alpha > 0.01 * alpha.max()).sum()}")

    mu, _ = gplvm.latents(res.params, cfg)
    # evaluate class structure in the dominant latent dims
    top = np.argsort(alpha)[::-1][:2]
    acc = knn_accuracy(np.asarray(mu)[:, top], labels)
    print(f"1-NN accuracy in top-2 latent dims: {acc:.3f} (chance ~0.33)")


if __name__ == "__main__":
    main()
