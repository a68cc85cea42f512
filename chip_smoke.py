"""Proof that the system's main path runs on one NVIDIA GPU.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --devices 4  # only the 4-card mesh phase

Phases (one process; it opens the card once, and the only child process,
nvidia-smi, never touches JAX):

1. device  — the card's name and power limit (nvidia-smi), device_kind, the
   JAX version and the psi engine that ``stats_impl="auto"`` picks.
2. parity  — the fused GPU psi kernels against the XLA engine
   (``psi.suff_stats`` at precision "highest") run on the card in float32
   and float64, at N=1e5, Q=10, D=12, M in {200, 500}, plus a ragged N with
   an M whose pair count is off the 64-pair tile: forward statistics and
   the gradients with respect to mu, s, Z, alpha and sf2.
3. main path — BASELINE config 4 (N=1e6, Q=10, M=200, D=12) through the CLI
   (``-T 5``, then a ``--load`` resume of 2 more), SGPR (``--fixed-
   embeddings``, same N, M, D) and SVGP (N=2e5, M=128, batch 4096, 300
   steps); plus compile time, warm time per bound+grad evaluation and peak
   device memory at config 4.

``--devices 4`` instead runs config 4 sharded over a 1-D mesh of 4 cards
(2.5e5 rows each) through ``gplvm.fit`` and the CLI, and compares the bound
and gradients with the same evaluation on one card.

Any failure raises, so the exit code is non-zero and no result is printed.
The last line of standard output is the JSON object
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Data is generated from ``--seed``; nothing is downloaded. Working files go
to a temporary directory inside the checkout, removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Parity tolerances, float32 against the float64 truth. The kernels'
# products run as TF32x3 (about float32 accuracy) and the exponents reach
# ~10 in magnitude, so float32 rounding of an exponent is ~1e-6 relative and
# sums over 1e5 rows add ~1e-6 more; the limits leave two orders of
# magnitude for the sum order and still catch a broken kernel. Errors are
# norm-scaled (max |a - b| / max |b|) because Psi1^T Y and the gradients mix
# signs.
VALUE_TOL = 2e-4
GRAD_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def require_gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX runs on {dev.platform!r})")
    return dev


def phase_device(dev) -> None:
    import jax
    import jax.numpy as jnp

    from bench import nvidia_smi
    from gparml.parallel.stats import choose_engine

    log(nvidia_smi())
    log(f"device_kind: {dev.device_kind}  devices: {len(jax.devices())}  "
        f"jax {jax.__version__}")
    log(f"psi engine (auto, float32): "
        f"{choose_engine('auto', jnp.float32)}")


def _parity_problem(n, q, m, d, seed):
    rng = np.random.default_rng(seed)
    return dict(
        y=rng.standard_normal((n, d)), mu=rng.standard_normal((n, q)),
        s=rng.uniform(0.1, 1.0, (n, q)), z=rng.standard_normal((m, q)),
        sf2=np.float64(1.3), alpha=rng.uniform(0.3, 2.0, q),
        wy=rng.standard_normal((m, d)), wp=rng.standard_normal((m, m)),
    )


def _stats_and_grads(stats_fn, pb, dtype):
    """Statistics and d(probe)/d(mu, s, z, sf2, alpha), computed on the
    card in ``dtype``."""
    import jax
    import jax.numpy as jnp

    def cast(x):
        return jnp.asarray(x, dtype)

    wy, wp, y = cast(pb["wy"]), cast(pb["wp"]), cast(pb["y"])

    def probe(mu, s, z, sf2, alpha):
        st = stats_fn(y, mu, s, z, sf2, alpha)
        return jnp.sum(st.psi1_y * wy) + jnp.sum(st.psi2 * wp), st

    fn = jax.jit(jax.value_and_grad(probe, argnums=(0, 1, 2, 3, 4),
                                    has_aux=True))
    (_, st), grads = fn(*(cast(pb[k]) for k in ("mu", "s", "z", "sf2",
                                                 "alpha")))
    return jax.device_get(st), jax.device_get(grads)


def phase_parity(seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from gparml.ops import psi, psi_gpu

    grad_names = ("mu", "s", "z", "sf2", "alpha")
    for n, m in ((100_000, 200), (100_000, 500), (99_991, 203)):
        q, d = 10, 12
        pb = _parity_problem(n, q, m, d, seed)
        t0 = time.perf_counter()
        with jax.enable_x64(True):
            st64, g64 = _stats_and_grads(psi.suff_stats, pb, jnp.float64)
        st_x, g_x = _stats_and_grads(psi.suff_stats, pb, jnp.float32)
        st_k, g_k = _stats_and_grads(psi_gpu.suff_stats, pb, jnp.float32)
        row = {"n": n, "m": m, "seconds": round(time.perf_counter() - t0, 3)}
        for engine, st, g in (("gpu", st_k, g_k), ("xla32", st_x, g_x)):
            row[engine] = {
                "psi2": rel_err(st.psi2, st64.psi2),
                "psi1_y": rel_err(st.psi1_y, st64.psi1_y),
                **{f"d_{k}": rel_err(a, b)
                   for k, a, b in zip(grad_names, g, g64)},
            }
        log("parity " + json.dumps(row))
        e = row["gpu"]
        bad = [k for k in ("psi2", "psi1_y") if not e[k] <= VALUE_TOL]
        bad += [k for k in e if k.startswith("d_") and not e[k] <= GRAD_TOL]
        if bad:
            raise AssertionError(f"GPU kernel parity failed at N={n}, M={m}: "
                                 f"{bad} ({e})")


def _peak(dev) -> str:
    return f"{dev.memory_stats()['peak_bytes_in_use'] / 2**30:.2f} GiB"


def phase_eval_timing(dev, n, q, m, d, seed) -> None:
    from bench import measure_eval

    r = measure_eval(n, m, "auto", q=q, d=d, reps=5, seed=seed)
    log(f"config-4 bound+grad eval (auto engine): compile+first "
        f"{r['compile_s']:.2f} s, warm median {r['median_s'] * 1e3:.1f} ms "
        f"(q25 {r['q25_s'] * 1e3:.1f}, q75 {r['q75_s'] * 1e3:.1f}), "
        f"peak {_peak(dev)}")


def _history(stats_dir, name="bound_history.jsonl", key="bound"):
    with open(os.path.join(stats_dir, name)) as f:
        return [json.loads(line)[key] for line in f]


def _check_monotone(bounds, what):
    b = np.asarray(bounds, np.float64)
    if b.size == 0 or not np.all(np.isfinite(b)):
        raise AssertionError(f"{what}: non-finite bound trajectory {bounds}")
    tol = 1e-6 * np.abs(b).max()
    if np.any(np.diff(b) < -tol):
        raise AssertionError(f"{what}: bound decreased {bounds}")


def _cli(args):
    from gparml import cli

    t0 = time.perf_counter()
    summary = cli.main(args)
    return summary, time.perf_counter() - t0


def phase_gplvm_cli(dev, work, n, q, m, d, seed) -> None:
    from gparml import data

    y, _ = data.synthetic_gplvm(n=n, d=d, q_true=3, seed=seed)
    inputs = os.path.join(work, "gplvm_in")
    data.save_partitioned(inputs, y.astype(np.float32), 4, prefix="Y")
    base = ["-i", inputs, "-e", os.path.join(work, "gplvm_emb"),
            "-s", os.path.join(work, "gplvm_st"), "-q", str(q), "-m", str(m),
            "--seed", str(seed)]
    s1, w1 = _cli(base + ["-T", "5"])
    b1 = _history(os.path.join(work, "gplvm_st"))
    _check_monotone(b1, "GPLVM -T 5")
    s2, w2 = _cli(base + ["-T", "2", "--load"])
    b2 = _history(os.path.join(work, "gplvm_st"))
    _check_monotone(b2, "GPLVM --load -T 2")
    _check_monotone([s1["final_bound"], s2["final_bound"]], "GPLVM resume")
    log(f"GPLVM CLI N={n} M={m}: -T 5 fit {s1['timings_s']['fit']} s "
        f"(compile included; {s1['n_evals']} evals), wall {w1:.1f} s, "
        f"bounds {[round(b, 1) for b in b1]}")
    log(f"GPLVM CLI --load -T 2: fit {s2['timings_s']['fit']} s "
        f"(persistent compile cache), bounds {[round(b, 1) for b in b2]}, "
        f"final {s2['final_bound']:.1f} >= {s1['final_bound']:.1f}; "
        f"peak {_peak(dev)}")


def phase_sgpr_cli(dev, work, n, q, m, d, seed) -> None:
    from gparml import data

    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((n, q)).astype(np.float32)
    w = rng.standard_normal((q, d)) / np.sqrt(q)
    y = (np.sin(x @ w) + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    inputs, emb = os.path.join(work, "sgpr_in"), os.path.join(work, "sgpr_x")
    data.save_partitioned(inputs, y, 4, prefix="Y")
    data.save_embeddings(emb, x, np.zeros_like(x), n_partitions=4)
    st = os.path.join(work, "sgpr_st")
    s, wall = _cli(["-i", inputs, "-e", emb, "-s", st, "-m", str(m),
                    "--fixed-embeddings", "-T", "5"])
    b = _history(st)
    _check_monotone(b, "SGPR -T 5")
    log(f"SGPR CLI N={n} Q={q} M={m}: -T 5 in {s['wall_time_s']} s "
        f"(compile included), bounds {[round(v, 1) for v in b]}; "
        f"peak {_peak(dev)}")


def phase_svgp_cli(dev, work, n, q, m, d, batch, steps, seed) -> None:
    from gparml import data

    rng = np.random.default_rng(seed + 2)
    x = rng.standard_normal((n, q)).astype(np.float32)
    w = rng.standard_normal((q, d)) / np.sqrt(q)
    y = (np.sin(x @ w) + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    inputs, emb = os.path.join(work, "svgp_in"), os.path.join(work, "svgp_x")
    data.save_partitioned(inputs, y, 4, prefix="Y")
    data.save_embeddings(emb, x, np.zeros_like(x), n_partitions=4)
    st = os.path.join(work, "svgp_st")
    s, wall = _cli(["-i", inputs, "-e", emb, "-s", st, "-m", str(m),
                    "--fixed-embeddings", "--optimizer", "svgp",
                    "--batch-size", str(batch), "-T", str(steps),
                    "--learning-rate", "0.01"])
    h = np.asarray(_history(st, "elbo_history.jsonl", "bound"))
    if not (np.isfinite(s["final_elbo"]) and np.all(np.isfinite(h))):
        raise AssertionError(f"SVGP: non-finite ELBO {s['final_elbo']}")
    first, last = h[:20].mean(), h[-20:].mean()
    if not last > first:
        raise AssertionError(f"SVGP: ELBO did not improve ({first} -> {last})")
    log(f"SVGP CLI N={n} M={m} batch {batch}: {steps} steps in {wall:.1f} s "
        f"(compile included), ELBO {first:.1f} -> {last:.1f}, final "
        f"{s['final_elbo']:.1f}; peak {_peak(dev)}")


def phase_mesh(work, n_devices, n, q, m, d, seed) -> None:
    """Config 4 over a 1-D mesh of ``n_devices`` cards against one card."""
    import jax
    import jax.numpy as jnp

    from bench import gplvm_problem
    from gparml import data
    from gparml.models import gplvm, params as P
    from gparml.parallel import mesh as mesh_lib

    devs = jax.devices()
    if len(devs) != n_devices:
        raise AssertionError(f"need {n_devices} GPUs, JAX sees {len(devs)}")
    params, y = gplvm_problem(n, m, q, d, seed)
    cfg = gplvm.GPLVMConfig(q=q, num_inducing=m)
    vg = jax.jit(lambda p, y, w, mesh=None: gplvm.neg_bound_value_and_grad(
        p, y, cfg, mesh=mesh, weights=w), static_argnames="mesh")
    f1, g1 = jax.device_get(vg(params, y, None))

    mesh = mesh_lib.make_mesh(n_devices)
    ys, mus, uss, w = mesh_lib.shard_data(
        mesh, np.asarray(y), np.asarray(params.lat.mu),
        np.asarray(params.lat.u_s))
    rep = mesh_lib.replicated(mesh)
    glob = jax.tree.map(lambda a: jax.device_put(a, rep), params.glob)
    p4 = P.GPLVMParams(glob=glob, lat=P.LatentParams(mu=mus, u_s=uss))
    t0 = time.perf_counter()
    f4, g4 = jax.device_get(vg(p4, ys, w, mesh=mesh))
    errs = {"bound": abs(float(f4) - float(f1)) / abs(float(f1))}
    for name, a, b in (("z", g4.glob.z, g1.glob.z),
                       ("alpha", g4.glob.u_alpha, g1.glob.u_alpha),
                       ("sf2", g4.glob.u_sf2, g1.glob.u_sf2),
                       ("mu", g4.lat.mu[:n], g1.lat.mu),
                       ("s", g4.lat.u_s[:n], g1.lat.u_s)):
        errs[f"d_{name}"] = rel_err(a, b)
    log(f"mesh x{n_devices} vs one card ({time.perf_counter() - t0:.1f} s "
        f"incl. compile): " + json.dumps(errs))
    if not (errs["bound"] <= VALUE_TOL
            and all(v <= GRAD_TOL for k, v in errs.items() if k != "bound")):
        raise AssertionError(f"mesh result differs from one card: {errs}")

    t0 = time.perf_counter()
    res = gplvm.fit(p4, ys, cfg, iters=3, mesh=mesh, weights=w)
    hist = np.asarray(res.history)
    _check_monotone(hist[np.isfinite(hist)], "mesh gplvm.fit")
    devs_of_mu = res.params.lat.mu.sharding.device_set
    if len(devs_of_mu) != n_devices:
        raise AssertionError(f"latents live on {len(devs_of_mu)} devices")
    log(f"gplvm.fit on the mesh, 3 iterations: {time.perf_counter() - t0:.1f}"
        f" s, bound {float(res.bound):.1f}")

    yd, _ = data.synthetic_gplvm(n=n, d=d, q_true=3, seed=seed)
    inputs = os.path.join(work, "mesh_in")
    data.save_partitioned(inputs, yd.astype(np.float32), n_devices,
                          prefix="Y")
    st = os.path.join(work, "mesh_st")
    s, wall = _cli(["-i", inputs, "-e", os.path.join(work, "mesh_emb"),
                    "-s", st, "-q", str(q), "-m", str(m), "-T", "3"])
    if s["devices"] != n_devices:
        raise AssertionError(f"CLI ran on {s['devices']} devices")
    _check_monotone(_history(st), "mesh CLI -T 3")
    peaks = [d.memory_stats()["peak_bytes_in_use"] for d in devs]
    log(f"CLI on {n_devices} cards: wall {wall:.1f} s, final bound "
        f"{s['final_bound']:.1f}; peak per card "
        f"{[f'{p / 2**30:.2f} GiB' for p in peaks]}")
    if max(peaks) > 2 * min(peaks) + 2**30:
        raise AssertionError(f"work piles up on one card: {peaks}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the 4-card mesh phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = require_gpu()
    import jax

    sys.path.insert(0, ROOT)
    from gparml.utils import compile_cache

    compile_cache.enable()
    phase_device(dev)
    n, q, m, d = 1_000_000, 10, 200, 12     # BASELINE config 4
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as work:
        if args.devices == 4:
            phase_mesh(work, 4, n, q, m, d, args.seed)
        else:
            phase_parity(args.seed)
            phase_eval_timing(dev, n, q, m, d, args.seed)
            phase_gplvm_cli(dev, work, n, q, m, d, args.seed)
            phase_sgpr_cli(dev, work, n, q, m, d, args.seed)
            phase_svgp_cli(dev, work, 200_000, 4, 128, 3, 4096, 300,
                           args.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
