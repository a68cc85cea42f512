"""Scaled-down BASELINE config-5 artifact: the config-5
SHAPE — GPLVM at M=500, Q=10, D=12, data sharded over a REAL 2-process
jax.distributed group (4 virtual CPU devices each, a 2-host stand-in) —
run end to end: per-host ingestion, distributed SCG, per-host embedding
writes, coordinator checkpoint. Asserts a finite monotone bound and reports
the coordinator's peak RSS.

N defaults to 48k (this container has ONE CPU core; the full config-5
N=1e7 is pure scale-out of the same program).

Usage: python tools/config5_dryrun.py [N] [T]
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(ROOT, "tests", "multihost_runner.py")
sys.path.insert(0, ROOT)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 48_000
    t = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    q, m, d = 10, 500, 12

    from gparml import data

    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs")
        emb = os.path.join(tmp, "emb")
        st = os.path.join(tmp, "st")
        y, _ = data.synthetic_gplvm(n=n, d=d, q_true=3, seed=11)
        data.save_partitioned(inputs, y.astype(np.float32), 8, prefix="Y")

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        out = os.path.join(tmp, "summary.json")
        cli_args = ["-i", inputs, "-e", emb, "-s", st, "-T", str(t),
                    "-q", str(q), "-m", str(m), "--stats-impl", "xla",
                    "--block", "4000", "-p", "remote"]
        env = dict(os.environ, PYTHONPATH=ROOT)
        procs = [
            subprocess.Popen(
                [sys.executable, RUNNER, "--process-id", str(pid),
                 "--num-processes", "2", "--port", str(port), "--devices", "4"]
                + (["--out", out] if pid == 0 else []) + ["--"] + cli_args,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env,
            )
            for pid in (0, 1)
        ]
        texts = [p.communicate(timeout=3600)[0] for p in procs]
        for p, text in zip(procs, texts):
            if p.returncode != 0:
                print(text[-4000:])
                raise SystemExit(f"process failed rc={p.returncode}")
        with open(out) as f:
            summary = json.load(f)

        hist_path = os.path.join(st, "bound_history.jsonl")
        bounds = [json.loads(l)["bound"] for l in open(hist_path)]
        assert np.all(np.isfinite(bounds)), bounds
        assert all(b2 >= b1 - 1e-3 * abs(b1)
                   for b1, b2 in zip(bounds, bounds[1:])), bounds
        # per-host embedding partitions: each host wrote exactly its block
        mu0 = np.load(os.path.join(emb, "X_mu_0.npy"))
        mu1 = np.load(os.path.join(emb, "X_mu_1.npy"))
        assert mu0.shape[0] + mu1.shape[0] == n
        assert mu0.shape[1] == q

        print(json.dumps({
            "config5_shape": {"n": n, "q": q, "m": m, "d": d,
                              "processes": 2, "devices_total": 8},
            "iters": t,
            "bounds": [round(b, 2) for b in bounds],
            "wall_time_s": summary["wall_time_s"],
            "coordinator_peak_rss_mb": summary.get("peak_rss_mb"),
            "per_host_rows": [int(mu0.shape[0]), int(mu1.shape[0])],
        }))


if __name__ == "__main__":
    main()
