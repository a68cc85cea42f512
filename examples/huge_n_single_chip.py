"""GPLVM training at BASELINE config 5 scale (N=10^7, Q=10, M=500) on one
GPU — the user-facing recipe:

  * ``stats_impl="auto"`` takes the fused GPU psi kernels for float32 on a
    GPU (the XLA scan elsewhere);
  * ``scg_mode="auto"`` switches to the host-stepped SCG driver above 2e6
    rows: one device program per iteration instead of one whole-fit
    while_loop program, with the optimizer state donated between programs.

Defaults are CPU-sized; the config-5 shape is

    python examples/huge_n_single_chip.py --n 10000000 --m 500 --iters 3
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--d", type=int, default=12)
    ap.add_argument("--q", type=int, default=10)
    ap.add_argument("--m", type=int, default=50)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from gparml.models import gplvm
    from gparml.models import params as P
    from gparml.utils import compile_cache

    compile_cache.enable()
    print(f"device: {jax.devices()[0].device_kind}")
    rng = np.random.default_rng(0)
    F = jnp.float32

    y = jnp.asarray(rng.standard_normal((args.n, args.d)), F)
    mu = jnp.asarray(rng.standard_normal((args.n, args.q)), F)
    s = jnp.full((args.n, args.q), 0.5, F)
    z = jnp.asarray(rng.standard_normal((args.m, args.q)), F)
    glob = jax.tree.map(lambda a: a.astype(F),
                        P.make_global(z, 1.0, np.ones(args.q), 10.0))
    params = P.GPLVMParams(glob=glob, lat=P.make_latents(mu, s))

    cfg = gplvm.GPLVMConfig(
        q=args.q, num_inducing=args.m,
        stats_impl="auto",            # fused kernels on a GPU, XLA elsewhere
        scg_mode="auto",              # stepped driver above 2e6 rows
    )

    t0 = time.perf_counter()
    res = gplvm.fit(params, y, cfg, iters=args.iters)
    bound = float(res.bound)
    wall = time.perf_counter() - t0
    hist = np.asarray(res.history)
    hist = hist[np.isfinite(hist)]
    print(f"N={args.n}: {len(hist)} SCG iterations in {wall:.1f} s "
          f"(incl. compile), bound {hist[0]:.1f} -> {bound:.1f}, "
          f"monotone={bool(np.all(np.diff(hist) >= -1e-3 * np.abs(hist[:-1])))}")


if __name__ == "__main__":
    main()
