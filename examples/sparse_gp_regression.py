"""Sparse variational GP regression demo (BASELINE config 1: N=1k, D=1, M=10).

Fits hyperparameters + inducing points with SCG and reports test RMSE and the
recovered noise level. Runs anywhere (CPU ok); uses a GPU if present.

    python examples/sparse_gp_regression.py
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
from gparml.models import params as P
from gparml.models import sgpr

compile_cache.enable()


def main():
    x_np, y_np = data.synthetic_regression(n=1000, noise_std=0.2, seed=0)
    x, y = jnp.asarray(x_np), jnp.asarray(y_np)

    cfg = sgpr.SGPRConfig(num_inducing=10)
    g0 = sgpr.init_params(jax.random.key(0), x, y, cfg)
    res = sgpr.fit(g0, x, y, cfg, iters=200)

    hist = np.asarray(res.history)
    hist = hist[np.isfinite(hist)]
    _, sf2, alpha, beta = P.constrain(res.params)
    print(f"bound: {hist[0]:.2f} -> {hist[-1]:.2f} "
          f"({int(res.n_evals)} objective evaluations)")
    print(f"learned noise std: {float(1/jnp.sqrt(beta)):.4f} (true 0.2)")

    xs = jnp.linspace(-3, 3, 200)[:, None]
    mean, var = sgpr.predict(res.params, x, y, xs, cfg)
    truth = np.sin(2 * np.asarray(xs)) + 0.5 * np.sin(5 * np.asarray(xs))
    rmse = float(np.sqrt(np.mean((np.asarray(mean) - truth) ** 2)))
    print(f"test RMSE vs noiseless truth: {rmse:.4f}")


if __name__ == "__main__":
    main()
