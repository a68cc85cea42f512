"""Command-line driver with the reference's option surface.

Re-design of GParML ``parallel_GPLVM.py`` (SURVEY.md §2/§3.1 [C-HIGH]): the
same workflow — folder setup, embedding init (PCA/random/load), Z + hyper
init, joint SCG optimization, results saved back to folders — with the
MapReduce pass replaced by one jit'd fused bound+gradient evaluation over the
device mesh. Option letters/names follow the reference where sensible
(SURVEY.md §5 config table [C-MED exact names]):

  -i/--input         folder of per-partition Y_<i>.npy files
  -e/--embeddings    folder for X_mu_<i>.npy / X_S_<i>.npy
  -p/--parallel      local (this host's devices) | remote (multi-host pod)
  -T/--iterations    optimizer iterations
  -q/--latent-dim    latent dimensionality Q
  -m/--num-inducing  inducing point count M
  -s/--statistics    output folder for history/checkpoints/timings
  --fixed-embeddings / --fixed-beta / --init {pca,random} / --load

Run ``python -m gparml.cli --help`` for the full surface.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gparml",
        description="Sparse variational GP / Bayesian GPLVM trainer",
    )
    p.add_argument("-i", "--input", required=True, help="folder of Y_<i>.npy partitions")
    p.add_argument("-e", "--embeddings", required=True, help="embeddings folder")
    p.add_argument("-p", "--parallel", choices=["local", "remote"], default="local")
    p.add_argument("-T", "--iterations", type=int, default=100)
    p.add_argument("-q", "--latent-dim", type=int, default=2, dest="q")
    p.add_argument("-m", "--num-inducing", type=int, default=10, dest="m")
    p.add_argument("-s", "--statistics", default=None, help="output folder for logs/checkpoints")
    p.add_argument("--fixed-embeddings", action="store_true",
                   help="treat embeddings as observed inputs (sparse GP regression mode)")
    p.add_argument("--fixed-beta", action="store_true", help="do not optimize noise precision")
    p.add_argument("--init", choices=["pca", "random"], default="pca")
    p.add_argument("--load", action="store_true",
                   help="resume: load existing embeddings (and checkpoint if present)")
    p.add_argument("--optimizer", choices=["scg", "adam", "gd", "svgp"], default="scg")
    p.add_argument("--xtol", type=float, default=1e-8,
                   help="SCG: min relative step size before convergence")
    p.add_argument("--ftol", type=float, default=1e-8,
                   help="SCG: min relative objective change before convergence")
    p.add_argument("--gtol", type=float, default=1e-10,
                   help="SCG: squared gradient norm convergence threshold")
    p.add_argument("--sigma0", type=float, default=1e-4,
                   help="SCG: finite-difference curvature probe scale")
    p.add_argument("--batch-size", type=int, default=4096,
                   help="minibatch size for --fixed-embeddings --optimizer svgp mode")
    p.add_argument("--learning-rate", type=float, default=1e-2)
    p.add_argument("--stats-impl", choices=["auto", "xla", "gpu"],
                   default="auto",
                   help="psi engine: auto picks the fused GPU kernels for "
                        "float32 on a GPU and the XLA scan otherwise")
    p.add_argument("--layout", choices=["nq", "qn"], default="nq",
                   help="storage layout of N-sized arrays: qn stores "
                        "everything transposed — (Q, N) latents/inputs, "
                        "(D, N) observations (single-device only, all "
                        "modes: GPLVM, SGPR, SVGP)")
    p.add_argument("--block", type=int, default=None,
                   help="N-block size for the scanned psi path (default: "
                        "derived from N, M and dtype so one step's slab "
                        "stays within 1 GiB)")
    p.add_argument("--scg-mode", choices=["auto", "fused", "stepped"],
                   default="auto", dest="scg_mode",
                   help="SCG driver: one fused while_loop program for the "
                        "whole fit, or one device program per iteration "
                        "(auto: stepped at/above 2e6 rows)")
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument("--bijector", choices=["exp", "softplus"], default="exp")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--display", action="store_true", help="per-iteration optimizer prints")
    p.add_argument("--trace-timing", action="store_true",
                   help="record REAL per-iteration wall times (adds a host "
                        "callback per iteration; history rows gain a wall_s column)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a jax.profiler trace (Perfetto/XProf) of the "
                        "fit into DIR (reference analog: per-pass wall-clock "
                        "prints, SURVEY §5 tracing row; here you get the full "
                        "XLA op/kernel timeline instead)")
    p.add_argument("--compile-cache", choices=["auto", "none"], default="auto",
                   help="persistent XLA compile cache: 'auto' keeps it in "
                        "$JAX_COMPILATION_CACHE_DIR if set, else in "
                        ".jax_cache at the checkout root; 'none' disables it. "
                        "Repeat and resume runs reuse compiled programs")
    p.add_argument("--save-partitions", type=int, default=None,
                   help="partition count for saved embeddings (default: match input)")
    return p


def _scg_options(options):
    """SCGOptions from the option namespace (tolerances optional so run()
    accepts any object with just the core attributes)."""
    from gparml.opt import scg

    defaults = scg.SCGOptions()
    return scg.SCGOptions(
        max_iters=options.iterations,
        display=options.display,
        xtol=getattr(options, "xtol", defaults.xtol),
        ftol=getattr(options, "ftol", defaults.ftol),
        gtol=getattr(options, "gtol", defaults.gtol),
        sigma0=getattr(options, "sigma0", defaults.sigma0),
        trace_timing=getattr(options, "trace_timing", False),
    )


def _maybe_iter_timer(options):
    """iteration_timer context when --trace-timing is set, else a no-op.
    Returns an object whose wall_seconds() (if any) yields real per-iteration
    wall clocks stamped by the optimizer's io_callback."""
    import contextlib

    if getattr(options, "trace_timing", False):
        from gparml.utils import logging as glog

        return glog.iteration_timer()
    return contextlib.nullcontext()


def _maybe_profile(options):
    """jax.profiler trace context when --profile DIR is set, else a no-op.
    (Multi-host runs: each process records its own devices; the profiler
    names trace files by host, so a shared DIR is safe.)"""
    import contextlib

    log_dir = getattr(options, "profile", None)
    if log_dir:
        from gparml.utils import logging as glog

        return glog.trace(log_dir)
    return contextlib.nullcontext()


def _history_with_wall(result, it_timer, iters: int):
    """History columns for write_history, plus a real wall_s column when
    --trace-timing collected stamps (the reference printed true
    per-iteration timings; the uniform average stays as the default)."""
    hist = result.trace if result.trace is not None else result.history
    ws = it_timer.wall_seconds() if hasattr(it_timer, "wall_seconds") else {}
    if not ws:
        return hist
    hist = dict(hist) if isinstance(hist, dict) else {"bound": hist}
    wall = np.full(int(iters), np.nan)
    for i, dt in ws.items():
        if 0 <= i < iters:
            wall[i] = dt
    hist["wall_s"] = np.round(wall, 6)
    return hist


def _iter_wall_extra(fit_seconds: float, history) -> dict:
    """Per-iteration wall-time column. The whole optimizer loop is ONE
    compiled call (no host round-trip per iteration), so the honest
    per-iteration figure is the uniform average over executed iterations."""
    n_iter = int(np.isfinite(np.asarray(history)).sum())
    return {"avg_iter_wall_s": round(fit_seconds / max(n_iter, 1), 6)}


def run(options) -> dict:
    """Execute a full training run; returns a summary dict (also written to
    the statistics folder). ``options`` is the parsed argparse namespace (or
    anything with the same attributes), mirroring the reference's run(options)
    entry point."""
    import jax
    import jax.numpy as jnp

    from gparml import checkpoint, data
    from gparml.models import gplvm, params as P, sgpr
    from gparml.parallel import mesh as mesh_lib
    from gparml.utils import logging as glog

    t_start = time.perf_counter()
    dtype = jnp.float64 if options.dtype == "float64" else jnp.float32
    if options.dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    # Persistent compile cache (default on): the reference's workflow is
    # run -> inspect -> resume, and with the bucketed SCG iteration budget
    # (opt/scg.py bucket_iters) a resume with a different -T reuses the first
    # run's compiled program.
    if getattr(options, "compile_cache", "auto") != "none":
        from gparml.utils import compile_cache

        compile_cache.enable()

    # ---- mesh + data ----
    # remote = multi-host: every process runs this same program; each loads
    # ONLY its own contiguous row block of the partition files (the
    # reference's per-partition worker reads, SURVEY.md §3.4) and builds
    # globally-sharded arrays from it — the dataset is never gathered.
    remote = options.parallel == "remote"
    if remote:
        from gparml.parallel import distributed

        distributed.initialize()
        mesh = distributed.global_mesh()
        n = data.partition_rows(options.input, prefix="Y")
        row_start, row_stop, _ = distributed.process_row_range(n)
        y_np = data.load_rows(
            options.input, row_start, min(row_stop, n), prefix="Y"
        )
        d = y_np.shape[1]
        writer = distributed.is_coordinator()
    else:
        distributed = None
        y_np = data.load_partitioned(options.input, prefix="Y")
        n, d = y_np.shape
        n_dev = len(jax.devices())
        mesh = mesh_lib.make_mesh(n_dev) if n_dev > 1 else None
        writer = True
    n_partitions = options.save_partitions or len(
        data._partition_files(options.input, prefix="Y")
    )

    timer = glog.Timer()
    timer.start("init")
    key = jax.random.key(options.seed)

    # ---- sparse-GP-regression mode (reference --fixed_embeddings with
    # observed inputs: s = 0, psi stats collapse to kernel products) ----
    if options.fixed_embeddings:
        if remote:
            n_x = data.partition_rows(options.embeddings, prefix="X_mu")
            if n_x != n:
                raise ValueError(
                    f"embeddings rows {n_x} != N={n}; --fixed-embeddings "
                    "needs observed inputs in the embeddings folder"
                )
            x_np, _ = data.load_embeddings_rows(
                options.embeddings, row_start, min(row_stop, n)
            )
        else:
            x_np, _ = data.load_embeddings(options.embeddings)
            if x_np.shape[0] != n:
                raise ValueError(
                    f"embeddings rows {x_np.shape[0]} != N={n}; "
                    "--fixed-embeddings needs observed inputs in the "
                    "embeddings folder"
                )
        sg_layout = getattr(options, "layout", "nq")
        if sg_layout == "qn":
            if remote:
                raise ValueError(
                    "--layout qn is the single-chip large-N mode; -p remote "
                    "shards (N, Q) rows"
                )
            mesh = None  # single-device affordance: skip the local mesh
            # host-side transposes: (Q, N)/(D, N) upload in compact form
            x = jnp.asarray(np.ascontiguousarray(x_np.T), dtype)
            y = jnp.asarray(np.ascontiguousarray(y_np.T), dtype)
        else:
            x = jnp.asarray(x_np, dtype)
            y = jnp.asarray(y_np, dtype)
        if options.optimizer == "svgp":
            from gparml.models import svgp as svgp_mod

            vcfg = svgp_mod.SVGPConfig(
                num_inducing=options.m, bijector=options.bijector,
                batch_size=options.batch_size, fixed_beta=options.fixed_beta,
                layout=sg_layout,
            )
            # init from this host's rows (remote: a local block — globals are
            # then agreed via broadcast, exactly like the collapsed modes)
            v0 = svgp_mod.init_params(jax.random.key(options.seed), x, y, vcfg)
            if options.load and options.statistics:
                vckpt = os.path.join(options.statistics, "checkpoint.npz")
                if os.path.exists(vckpt):
                    v0, vmeta = checkpoint.load(vckpt, v0)
                    v0 = jax.tree.map(lambda a: jnp.asarray(a, dtype), v0)
                    if writer:
                        print(f"resumed from {vckpt} "
                              f"(iteration {vmeta.get('iteration')})")
            weights = None
            if remote:
                v0 = distributed.broadcast_pytree(jax.tree.map(np.asarray, v0))
                v0 = jax.tree.map(lambda a: jnp.asarray(a, dtype), v0)
                v0 = distributed.replicate(mesh, v0)
                y, x, weights = distributed.shard_data_multihost(
                    mesh, n, np.asarray(y), np.asarray(x)
                )
            elif mesh is not None:
                y, x, weights = mesh_lib.shard_data(mesh, np.asarray(y), np.asarray(x))
            timer.stop("init")
            timer.start("fit")
            with _maybe_profile(options):
                vres = svgp_mod.fit(v0, x, y, vcfg, steps=options.iterations,
                                    learning_rate=options.learning_rate,
                                    mesh=mesh, weights=weights)
                float(vres.elbo)  # sync so the trace covers the whole fit
            timer.stop("fit")
            summary = {
                "mode": "svgp", "n": n, "d": d, "m": options.m,
                "iterations": options.iterations, "batch_size": vcfg.batch_size,
                "final_elbo": float(vres.elbo),
                # estimator provenance: exact full-data ELBO vs unbiased
                # subset estimate over elbo_n rows (svgp._EXACT_ELBO_MAX_N)
                "final_elbo_exact": bool(vres.elbo_exact),
                "final_elbo_n": int(vres.elbo_n),
                "devices": len(jax.devices()),
                "parallel": options.parallel,
                "wall_time_s": round(time.perf_counter() - t_start, 3),
            }
            if options.statistics and writer:
                os.makedirs(options.statistics, exist_ok=True)
                glog.write_history(
                    os.path.join(options.statistics, "elbo_history.jsonl"),
                    vres.history,
                )
                checkpoint.save(
                    os.path.join(options.statistics, "checkpoint.npz"),
                    jax.tree.map(np.asarray, vres.params),
                    meta={"iteration": options.iterations,
                          "bound": float(vres.elbo)},
                )
                with open(os.path.join(options.statistics, "summary.json"), "w") as f:
                    json.dump(summary, f, indent=2)
            if writer:
                print(json.dumps(summary))
            return summary
        scfg = sgpr.SGPRConfig(
            num_inducing=options.m, bijector=options.bijector,
            block=options.block, fixed_beta=options.fixed_beta,
            layout=sg_layout,
            scg_mode=getattr(options, "scg_mode", "auto"),
        )
        g0 = sgpr.init_params(key, x, y, scfg)
        if options.load and options.statistics:
            sckpt = os.path.join(options.statistics, "checkpoint.npz")
            if os.path.exists(sckpt):
                g0, smeta = checkpoint.load(sckpt, g0)
                g0 = jax.tree.map(lambda a: jnp.asarray(a, dtype), g0)
                if writer:
                    print(f"resumed from {sckpt} "
                          f"(iteration {smeta.get('iteration')})")
        weights = None
        if remote:
            # init used this host's block only; globals must agree everywhere
            g0 = distributed.broadcast_pytree(jax.tree.map(np.asarray, g0))
            g0 = jax.tree.map(lambda a: jnp.asarray(a, dtype), g0)
            g0 = distributed.replicate(mesh, g0)
            y, x, weights = distributed.shard_data_multihost(
                mesh, n, np.asarray(y), np.asarray(x)
            )
        elif mesh is not None:
            # Shard the dtype-converted arrays (NOT the raw on-disk ones) so
            # --dtype float64 data and the padding weights match the params.
            y, x, weights = mesh_lib.shard_data(mesh, np.asarray(y), np.asarray(x))
        timer.stop("init")
        timer.start("fit")
        scg_options = _scg_options(options)
        with _maybe_profile(options), _maybe_iter_timer(options) as it_timer:
            result = sgpr.fit(
                g0, x, y, scfg, iters=options.iterations,
                optimizer=options.optimizer, learning_rate=options.learning_rate,
                scg_options=scg_options if options.optimizer == "scg" else None,
                mesh=mesh, weights=weights,
            )
            float(result.bound)  # sync so trailing stamps land inside the timer
        fit_s = timer.stop("fit")
        summary = {
            "mode": "sgpr", "n": n, "d": d, "m": options.m,
            "optimizer": options.optimizer, "iterations": options.iterations,
            "n_evals": int(result.n_evals), "final_bound": float(result.bound),
            "devices": len(jax.devices()), "parallel": options.parallel,
            "wall_time_s": round(time.perf_counter() - t_start, 3),
        }
        if options.statistics and writer:
            os.makedirs(options.statistics, exist_ok=True)
            glog.write_history(
                os.path.join(options.statistics, "bound_history.jsonl"),
                _history_with_wall(result, it_timer, options.iterations),
                extra=_iter_wall_extra(fit_s, result.history),
            )
            checkpoint.save(
                os.path.join(options.statistics, "checkpoint.npz"),
                jax.tree.map(np.asarray, result.params),
                meta={"iteration": options.iterations, "bound": float(result.bound)},
            )
            with open(os.path.join(options.statistics, "summary.json"), "w") as f:
                json.dump(summary, f, indent=2)
        if writer:
            print(json.dumps(summary))
        return summary

    # ---- model + params ----
    layout = getattr(options, "layout", "nq")
    if layout == "qn":
        if remote:
            raise ValueError(
                "--layout qn is the single-chip large-N mode; -p remote "
                "shards (N, Q) rows"
            )
        mesh = None  # single-device affordance: skip the local mesh
    cfg = gplvm.GPLVMConfig(
        q=options.q,
        num_inducing=options.m,
        bijector=options.bijector,
        block=options.block,
        stats_impl=options.stats_impl,
        init=options.init,
        fixed_beta=options.fixed_beta,
        layout=layout,
        # pair the transposed latent storage with transposed observations
        y_layout="dn" if layout == "qn" else "nd",
        scg_mode=getattr(options, "scg_mode", "auto"),
    )
    # host-side transpose: the (D, N) array uploads in its compact form
    y = jnp.asarray(y_np.T if layout == "qn" else y_np, dtype)

    if options.load and os.path.isdir(options.embeddings):
        if remote:
            n_emb = data.partition_rows(options.embeddings, prefix="X_mu")
            if n_emb != n:
                raise ValueError(
                    f"loaded embeddings have {n_emb} rows, expected N={n}"
                )
            mu_np, s_np = data.load_embeddings_rows(
                options.embeddings, row_start, min(row_stop, n)
            )
        else:
            mu_np, s_np = data.load_embeddings(options.embeddings)
            if mu_np.shape != (n, options.q):
                raise ValueError(
                    f"loaded embeddings {mu_np.shape} do not match "
                    f"(N={n}, Q={options.q})"
                )
        if mu_np.shape[1] != options.q:
            raise ValueError(
                f"loaded embeddings have Q={mu_np.shape[1]}, expected {options.q}"
            )
        k1, _ = jax.random.split(key)
        from gparml.utils import init as init_utils

        # Raw NUMPY in, never jnp.asarray here: make_latents' host branch
        # transposes on host so only the (Q, N) form uploads.
        np_dtype = np.dtype(options.dtype)
        lat = P.make_latents(mu_np.astype(np_dtype, copy=False),
                             s_np.astype(np_dtype, copy=False),
                             bijector=options.bijector, layout=layout)
        # Inducing selection likewise stays small: uniform host-side
        # candidate subset (numpy indexing), then FPS on device over (C, Q).
        cand_np = init_utils.host_candidate_rows(
            mu_np, options.m, seed=options.seed
        )
        z = init_utils.init_inducing(k1, jnp.asarray(cand_np, dtype), options.m)
        glob = P.make_global(z, 1.0, np.ones(options.q),
                             10.0 / max(float(np.var(y_np)), 1e-6),
                             bijector=options.bijector)
        glob = jax.tree.map(lambda a: a.astype(dtype), glob)
        params = P.GPLVMParams(glob=glob, lat=lat)
    else:
        # In remote mode this initializes from THIS host's block (local PCA
        # per partition is exactly the reference's init, SURVEY.md §3.5);
        # globals are then agreed via broadcast below.
        params = gplvm.init_params(key, y, cfg)

    ckpt_path = None
    if options.statistics:
        ckpt_path = os.path.join(options.statistics, "checkpoint.npz")
        if options.load and os.path.exists(ckpt_path):
            if remote:
                # multi-host checkpoints hold globals only; the latents live
                # in the embeddings folder (loaded per-host above)
                glob, meta = checkpoint.load(ckpt_path, params.glob)
                glob = jax.tree.map(lambda a: jnp.asarray(a, dtype), glob)
                params = P.GPLVMParams(glob=glob, lat=params.lat)
            else:
                params, meta = checkpoint.load(ckpt_path, params)
            if writer:
                print(f"resumed from {ckpt_path} "
                      f"(iteration {meta.get('iteration')})")

    weights = None
    if remote:
        glob = distributed.broadcast_pytree(
            jax.tree.map(np.asarray, params.glob)
        )
        glob = distributed.replicate(
            mesh, jax.tree.map(lambda a: np.asarray(a, dtype), glob)
        )
        y, mu_s, us_s, weights = distributed.shard_data_multihost(
            mesh, n, np.asarray(y),
            np.asarray(params.lat.mu), np.asarray(params.lat.u_s),
        )
        params = P.GPLVMParams(glob=glob, lat=P.LatentParams(mu=mu_s, u_s=us_s))
    elif mesh is not None:
        y, mu_s, us_s, weights = mesh_lib.shard_data(
            mesh, np.asarray(y), np.asarray(params.lat.mu), np.asarray(params.lat.u_s)
        )
        rep = mesh_lib.replicated(mesh)
        glob = jax.tree.map(lambda a: jax.device_put(a, rep), params.glob)
        params = P.GPLVMParams(glob=glob, lat=P.LatentParams(mu=mu_s, u_s=us_s))
    timer.stop("init")

    # ---- fit ----
    timer.start("fit")
    scg_options = _scg_options(options)
    with _maybe_profile(options), _maybe_iter_timer(options) as it_timer:
        result = gplvm.fit(
            params, y, cfg,
            iters=options.iterations,
            optimizer=options.optimizer,
            learning_rate=options.learning_rate,
            scg_options=scg_options if options.optimizer == "scg" else None,
            mesh=mesh, weights=weights,
        )
        final_bound = float(result.bound)  # sync inside the timer
    fit_s = timer.stop("fit")

    # ---- save ----
    timer.start("save")
    if layout == "qn":
        # pull the (Q, N) leaves and transpose on HOST, not on the device
        # while the SCG state still holds its memory
        mu_t, s_t = P.constrain_latents(
            result.params.lat, options.bijector, "qn", native=True)
        mu, s = np.asarray(mu_t).T, np.asarray(s_t).T
    else:
        mu, s = gplvm.latents(result.params, cfg)
    if remote:
        # Each host persists exactly its own block as one partition file —
        # the reference's per-partition writes; nothing is gathered. Rows
        # beyond N (mesh padding, all on the last host) are trimmed.
        n_valid = max(0, min(row_stop, n) - row_start)
        mu_np = distributed.local_block(mu)[:n_valid]
        s_np = distributed.local_block(s)[:n_valid]
        data.save_embeddings_partition(
            options.embeddings, mu_np, s_np, partition=jax.process_index()
        )
        distributed.barrier("embeddings_saved")
    else:
        mu_np = np.asarray(mu)[:n]
        s_np = np.asarray(s)[:n]
        data.save_embeddings(options.embeddings, mu_np, s_np, n_partitions)
    summary = {
        "n": n, "d": d, "q": options.q, "m": options.m,
        "optimizer": options.optimizer,
        "stats_impl": options.stats_impl,
        "iterations": options.iterations,
        "n_evals": int(result.n_evals),
        "final_bound": final_bound,
        "devices": len(jax.devices()),
        "parallel": options.parallel,
    }
    if options.statistics and writer:
        os.makedirs(options.statistics, exist_ok=True)
        glog.write_history(
            os.path.join(options.statistics, "bound_history.jsonl"),
            _history_with_wall(result, it_timer, options.iterations),
            extra=_iter_wall_extra(fit_s, result.history),
        )
        meta = {"iteration": options.iterations, "bound": final_bound,
                "config": {k: v for k, v in vars(options).items()
                           if isinstance(v, (int, float, str, bool, type(None)))}}
        if remote:
            # globals only; the per-host embedding partition files ARE the
            # latent state (exactly the reference's checkpoint shape)
            checkpoint.save(
                ckpt_path, jax.tree.map(np.asarray, result.params.glob),
                meta=meta,
            )
        else:
            # Checkpoint UNPADDED latents: the mesh pads N to a device-count
            # multiple, and a resume may run on a different device count.
            # (N is axis 1 under the qn layout.)
            trim = (lambda a: np.asarray(a)[:, :n]) if layout == "qn" else (
                lambda a: np.asarray(a)[:n])
            lat_trim = P.LatentParams(
                mu=trim(result.params.lat.mu),
                u_s=trim(result.params.lat.u_s),
            )
            ckpt_params = P.GPLVMParams(
                glob=jax.tree.map(np.asarray, result.params.glob), lat=lat_trim
            )
            checkpoint.save(ckpt_path, ckpt_params, meta=meta)
    timer.stop("save")
    summary["wall_time_s"] = round(time.perf_counter() - t_start, 3)
    summary["timings_s"] = {k: round(v, 3) for k, v in timer.summary().items()}
    if options.statistics and writer:
        with open(os.path.join(options.statistics, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    if writer:
        print(json.dumps(summary))
    return summary


def main(argv=None):
    options = build_parser().parse_args(argv)
    return run(options)


if __name__ == "__main__":
    main()
