"""Large-scale GPLVM bound+gradient timing (BASELINE config 4 shape:
N=1e6, Q=10, M=200 — scaled by --n) on all available devices, exercising the
data-parallel mesh and both psi-statistics engines ('auto', which is the
fused kernels for float32 on a GPU, and the XLA scan).

    python examples/large_scale_gplvm.py --n 100000 --m 200
"""

import argparse
import sys
import os
import time
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=12)
    ap.add_argument("--q", type=int, default=10)
    ap.add_argument("--m", type=int, default=200)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from gparml.models import gplvm
    from gparml.models import params as P
    from gparml.parallel import mesh as mesh_lib
    from gparml.utils import compile_cache

    compile_cache.enable()
    devs = jax.devices()
    print(f"{len(devs)} device(s): {devs[0].device_kind}")
    rng = np.random.default_rng(0)
    F = jnp.float32
    y = rng.standard_normal((args.n, args.d)).astype(np.float32)
    mu = rng.standard_normal((args.n, args.q)).astype(np.float32)
    s = np.full((args.n, args.q), 0.5, np.float32)
    z = jnp.asarray(rng.standard_normal((args.m, args.q)), F)
    glob = jax.tree.map(lambda a: a.astype(F), P.make_global(z, 1.0, np.ones(args.q), 10.0))

    mesh = mesh_lib.make_mesh(len(devs)) if len(devs) > 1 else None
    weights = None
    if mesh is not None:
        y_s, mu_s, us_s, weights = mesh_lib.shard_data(mesh, y, mu, np.log(s))
        y_j, params = y_s, P.GPLVMParams(glob=glob, lat=P.LatentParams(mu=mu_s, u_s=us_s))
    else:
        y_j = jnp.asarray(y)
        params = P.GPLVMParams(glob=glob, lat=P.make_latents(jnp.asarray(mu), jnp.asarray(s)))

    for impl in ("auto", "xla"):
        cfg = gplvm.GPLVMConfig(q=args.q, num_inducing=args.m, stats_impl=impl)
        f = jax.jit(lambda p, y: gplvm.neg_bound_value_and_grad(p, y, cfg, mesh=mesh, weights=weights))
        jax.block_until_ready(f(params, y_j))
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(f(params, y_j))
            ts.append(time.perf_counter() - t0)
        print(f"{impl:5s}: {np.median(ts) * 1e3:8.1f} ms / bound+grad eval "
              f"(median of 3, warm)")


if __name__ == "__main__":
    main()
