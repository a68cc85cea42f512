"""Benchmark: one jitted GPLVM bound+gradient evaluation on one GPU, the
fused psi kernels (``stats_impl="gpu"``, what ``auto`` picks for float32 on
a GPU) against the XLA blocked scan with its derived block
(``stats_impl="xla"``), at BASELINE config 4 (N=1e6, Q=10, M=200, D=12),
N=1e5/M=500 and config 5 (N=1e7, M=500).

Every record names the device (platform, device_kind, count) and the card's
name and power limit from nvidia-smi. Times are host clock around calls that
end in block_until_ready: compile (first call) as set-up, then the median
and quartiles of ``--reps`` warm calls. The run fails — non-zero exit, no
result — without a GPU, on a device kind missing from PEAKS, or when any
measurement fails.

Run: python bench.py [--reps 5] [--shapes 1e6x200,1e5x500,1e7x500]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# Published peaks by jax device_kind (NVIDIA H100 SXM data sheet, dense,
# at the 700 W power limit). A kind not listed is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_tflops": 67.0, "tf32_tflops": 495.0, "hbm_tb_per_s": 3.35,
        "source": "NVIDIA H100 SXM data sheet",
    },
}

DEFAULT_SHAPES = "1e6x200,1e5x500,1e7x500"


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def device_record() -> dict:
    """platform / device_kind / count of the default backend; raises
    without a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {dev.platform!r}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def peak_bytes(dev=None) -> int:
    import jax

    dev = dev or jax.devices()[0]
    return int(dev.memory_stats()["peak_bytes_in_use"])


def gplvm_problem(n, m, q=10, d=12, seed=0):
    """Random config-shaped GPLVM parameters and data (float32, device)."""
    import jax
    import jax.numpy as jnp
    from gparml.models import params as P

    rng = np.random.default_rng(seed)
    y = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    mu = jnp.asarray(rng.standard_normal((n, q)), jnp.float32)
    s = jnp.full((n, q), 0.5, jnp.float32)
    z = jnp.asarray(rng.standard_normal((m, q)), jnp.float32)
    glob = jax.tree.map(lambda a: a.astype(jnp.float32),
                        P.make_global(z, 1.0, np.ones(q), 10.0))
    return P.GPLVMParams(glob=glob, lat=P.make_latents(mu, s)), y


def measure_eval(n, m, impl, q=10, d=12, reps=5, seed=0) -> dict:
    """Compile time and warm times of one jitted neg_bound_value_and_grad."""
    import jax
    from gparml.models import gplvm

    params, y = gplvm_problem(n, m, q, d, seed)
    cfg = gplvm.GPLVMConfig(q=q, num_inducing=m, stats_impl=impl)
    fn = jax.jit(lambda p, y: gplvm.neg_bound_value_and_grad(p, y, cfg))
    t0 = time.perf_counter()
    f, _ = jax.block_until_ready(fn(params, y))
    compile_s = time.perf_counter() - t0
    if not np.isfinite(float(f)):
        raise RuntimeError(f"non-finite bound at n={n} m={m} impl={impl}")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(params, y))
        times.append(time.perf_counter() - t0)
    q25, med, q75 = np.percentile(times, [25, 50, 75])
    return {"n": n, "m": m, "impl": impl, "compile_s": compile_s,
            "median_s": float(med), "q25_s": float(q25), "q75_s": float(q75),
            "times_s": times, "neg_bound": float(f),
            "peak_bytes": peak_bytes()}


def _shapes(spec: str):
    out = []
    for item in spec.split(","):
        n, m = item.lower().split("x")
        out.append((int(float(n)), int(m)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--shapes", default=DEFAULT_SHAPES,
                    help="comma-separated NxM list (Q=10, D=12)")
    args = ap.parse_args(argv)

    import jax

    from gparml.utils import compile_cache

    compile_cache.enable()
    device = device_record()
    if device["kind"] not in PEAKS:
        raise RuntimeError(f"no published peaks for {device['kind']!r}; "
                           "add them to PEAKS")
    smi = nvidia_smi()
    print(f"card: {smi}")
    print(f"device: {device} jax {jax.__version__}")
    rows = []
    for n, m in _shapes(args.shapes):
        pair = {}
        for impl in ("gpu", "xla"):
            pair[impl] = measure_eval(n, m, impl, reps=args.reps)
            print(json.dumps(pair[impl]))
        rows.append({"n": n, "m": m,
                     "gpu_median_s": pair["gpu"]["median_s"],
                     "xla_median_s": pair["xla"]["median_s"],
                     "speedup": pair["xla"]["median_s"]
                     / pair["gpu"]["median_s"]})
    print(json.dumps({"metric": "GPLVM bound+grad eval seconds (median)",
                      "card": smi, "device": device,
                      "peaks": PEAKS[device["kind"]], "rows": rows}))


if __name__ == "__main__":
    sys.exit(main())
