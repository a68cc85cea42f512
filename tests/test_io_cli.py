"""Data IO, checkpoint/resume, and end-to-end CLI tests (the reference's
folder contract + --load resume, SURVEY.md §5)."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gparml import checkpoint, data
from gparml.models import gplvm
from gparml.models import params as P


def test_partitioned_roundtrip(tmp_path, rng):
    arr = rng.standard_normal((103, 4))
    paths = data.save_partitioned(str(tmp_path), arr, 7, prefix="Y")
    assert len(paths) == 7
    back = data.load_partitioned(str(tmp_path), prefix="Y")
    np.testing.assert_array_equal(back, arr)


def test_embeddings_roundtrip(tmp_path, rng):
    mu = rng.standard_normal((50, 3))
    s = rng.uniform(0.1, 1.0, (50, 3))
    data.save_embeddings(str(tmp_path), mu, s, n_partitions=4)
    mu2, s2 = data.load_embeddings(str(tmp_path))
    np.testing.assert_array_equal(mu2, mu)
    np.testing.assert_array_equal(s2, s)


def test_missing_partition_folder_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        data.load_partitioned(str(tmp_path))


def test_checkpoint_roundtrip(tmp_path, rng):
    y = jnp.asarray(rng.standard_normal((20, 4)))
    cfg = gplvm.GPLVMConfig(q=2, num_inducing=5)
    params = gplvm.init_params(jax.random.key(0), y, cfg)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, params, meta={"iteration": 7, "bound": -1.5})
    loaded, meta = checkpoint.load(path, params)
    assert meta["iteration"] == 7
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cli_end_to_end_and_resume(tmp_path, rng):
    """Full reference workflow: partitioned inputs -> fit -> embeddings saved
    -> resume with --load improves (or keeps) the bound."""
    from gparml import cli

    y, _ = data.synthetic_gplvm(n=48, d=5, q_true=1, seed=1)
    inputs = tmp_path / "inputs"
    emb = tmp_path / "embeddings"
    stats = tmp_path / "statistics"
    data.save_partitioned(str(inputs), y, 3, prefix="Y")

    argv = [
        "-i", str(inputs), "-e", str(emb), "-s", str(stats),
        "-T", "15", "-q", "2", "-m", "6", "--seed", "0",
    ]
    summary1 = cli.main(argv)
    assert np.isfinite(summary1["final_bound"])
    assert (emb / "X_mu_0.npy").exists()
    assert (stats / "checkpoint.npz").exists()
    assert (stats / "bound_history.jsonl").exists()
    with open(stats / "bound_history.jsonl") as f:
        lines = [json.loads(l) for l in f]
    assert lines and lines[-1]["bound"] == pytest.approx(summary1["final_bound"], rel=1e-5)
    # per-iteration observability: every row carries the full SCG trace
    for row in lines:
        assert {"iteration", "bound", "gnorm2", "lambda", "alpha",
                "accepted", "avg_iter_wall_s"} <= set(row)
        assert isinstance(row["accepted"], bool)
        assert row["gnorm2"] >= 0 and row["avg_iter_wall_s"] > 0

    # resume
    summary2 = cli.main(argv + ["--load"])
    assert summary2["final_bound"] >= summary1["final_bound"] - 1e-3


def test_cli_scg_mode_stepped(tmp_path, rng):
    """--scg-mode stepped drives the host-stepped SCG driver end-to-end
    (the config-5 large-N driver, here at CI scale) through both model
    families' CLI paths."""
    from gparml import cli

    y, _ = data.synthetic_gplvm(n=32, d=4, q_true=1, seed=9)
    inputs = tmp_path / "inputs"
    data.save_partitioned(str(inputs), y, 2, prefix="Y")
    summary = cli.main([
        "-i", str(inputs), "-e", str(tmp_path / "emb"),
        "-T", "6", "-q", "2", "-m", "5", "--scg-mode", "stepped",
    ])
    assert np.isfinite(summary["final_bound"])

    # SGPR mode (--fixed-embeddings): embeddings folder holds observed X
    inputs2 = tmp_path / "inputs2"
    emb2 = tmp_path / "emb2"
    x = np.sort(rng.uniform(-2, 2, (30, 1)), axis=0)
    ys = np.cos(x) + 0.1 * rng.standard_normal((30, 1))
    data.save_partitioned(str(inputs2), ys, 2, prefix="Y")
    data.save_embeddings(str(emb2), x, np.full_like(x, 1e-6), n_partitions=2)
    summary2 = cli.main([
        "-i", str(inputs2), "-e", str(emb2),
        "-T", "6", "-q", "1", "-m", "5",
        "--fixed-embeddings", "--scg-mode", "stepped",
    ])
    assert summary2["mode"] == "sgpr"
    assert np.isfinite(summary2["final_bound"])


def test_cli_adam_and_fixed_beta(tmp_path, rng):
    from gparml import cli

    y, _ = data.synthetic_gplvm(n=32, d=4, q_true=1, seed=2)
    inputs = tmp_path / "inputs"
    data.save_partitioned(str(inputs), y, 2, prefix="Y")
    summary = cli.main([
        "-i", str(inputs), "-e", str(tmp_path / "emb"),
        "-T", "10", "-q", "2", "-m", "5",
        "--optimizer", "adam", "--fixed-beta",
    ])
    assert np.isfinite(summary["final_bound"])


def test_cli_fixed_embeddings_sgpr_mode(tmp_path, rng):
    """--fixed-embeddings: embeddings folder holds OBSERVED inputs; the CLI
    runs sparse GP regression (reference §3.2)."""
    from gparml import cli

    x = np.sort(rng.uniform(-2, 2, (60, 1)), axis=0)
    y = np.sin(2 * x) + 0.1 * rng.standard_normal((60, 1))
    inputs = tmp_path / "inputs"
    emb = tmp_path / "emb"
    data.save_partitioned(str(inputs), y, 2, prefix="Y")
    data.save_embeddings(str(emb), x, np.full_like(x, 1e-6), n_partitions=2)

    summary = cli.main([
        "-i", str(inputs), "-e", str(emb), "-s", str(tmp_path / "st"),
        "-T", "30", "-q", "1", "-m", "8", "--fixed-embeddings",
        "--dtype", "float64",
    ])
    assert summary["mode"] == "sgpr"
    assert np.isfinite(summary["final_bound"])


def test_cli_resume_uneven_n(tmp_path, rng):
    """N not divisible by the device count: the mesh pads latents, but
    checkpoints must store unpadded shapes so resume works anywhere."""
    from gparml import cli

    y, _ = data.synthetic_gplvm(n=43, d=4, q_true=1, seed=3)  # 43 % 8 != 0
    inputs = tmp_path / "inputs"
    data.save_partitioned(str(inputs), y, 3, prefix="Y")
    argv = [
        "-i", str(inputs), "-e", str(tmp_path / "emb"), "-s", str(tmp_path / "st"),
        "-T", "8", "-q", "2", "-m", "5",
    ]
    s1 = cli.main(argv)
    with np.load(tmp_path / "st" / "checkpoint.npz") as f:
        assert f["lat/mu"].shape == (43, 2)
    s2 = cli.main(argv + ["--load"])
    assert np.isfinite(s2["final_bound"])


def test_cli_qn_resume_stays_host_side(tmp_path, rng, monkeypatch):
    """--layout qn --load: the resume path must hand make_latents RAW numpy
    (its host branch transposes so only the compact (Q, N) form uploads) and
    select inducing candidates by host-side numpy indexing. Wrapping
    jnp.asarray in cli would re-introduce the whole-array (N, Q) upload
    the transposed layout exists to avoid."""
    from gparml import cli
    from gparml.models import params as P

    y, _ = data.synthetic_gplvm(n=40, d=4, q_true=1, seed=5)
    inputs = tmp_path / "inputs"
    argv = [
        "-i", str(inputs), "-e", str(tmp_path / "emb"), "-s", str(tmp_path / "st"),
        "-T", "8", "-q", "2", "-m", "5", "--layout", "qn",
    ]
    data.save_partitioned(str(inputs), y, 2, prefix="Y")
    s1 = cli.main(argv)

    seen = {}
    orig = P.make_latents

    def spy(mu, s, **kw):
        seen["mu_is_numpy"] = not isinstance(mu, jnp.ndarray)
        seen["s_is_numpy"] = not isinstance(s, jnp.ndarray)
        return orig(mu, s, **kw)

    # cli does `from gparml.models import params as P` inside main(), so
    # patching the module attribute intercepts its call
    monkeypatch.setattr(P, "make_latents", spy)
    s2 = cli.main(argv + ["--load"])
    assert np.isfinite(s2["final_bound"])
    assert s2["final_bound"] >= s1["final_bound"] - 1e-3
    assert seen.get("mu_is_numpy") and seen.get("s_is_numpy")


def test_host_candidate_rows_compact_and_deterministic(rng):
    from gparml.utils.init import host_candidate_rows

    x = rng.standard_normal((20000, 3))
    c1 = host_candidate_rows(x, m=8, seed=7)
    c2 = host_candidate_rows(x, m=8, seed=7)
    assert isinstance(c1, np.ndarray) and c1.shape == (4096, 3)
    np.testing.assert_array_equal(c1, c2)
    # rows are genuine rows of x (an index subset, no averaging/mixing)
    assert np.isin(c1[:, 0], x[:, 0]).all()
    small = host_candidate_rows(x[:100], m=8, seed=7)
    assert small.shape == (100, 3)


def test_cli_sgpr_resume(tmp_path, rng):
    """--fixed-embeddings + --load must restore globals from checkpoint.npz
    (round-1 gap: --load was silently ignored outside the GPLVM branch)."""
    from gparml import cli

    x = np.sort(rng.uniform(-2, 2, (60, 1)), axis=0)
    y = np.sin(2 * x) + 0.1 * rng.standard_normal((60, 1))
    inputs = tmp_path / "inputs"
    emb = tmp_path / "emb"
    stats = tmp_path / "st"
    data.save_partitioned(str(inputs), y, 2, prefix="Y")
    data.save_embeddings(str(emb), x, np.full_like(x, 1e-6), n_partitions=2)
    argv = [
        "-i", str(inputs), "-e", str(emb), "-s", str(stats),
        "-T", "25", "-q", "1", "-m", "8", "--fixed-embeddings",
    ]
    s1 = cli.main(argv)
    s2 = cli.main(argv + ["--load", "-T", "5"])
    # 5 iterations from the restored optimum stay at (or improve on) the
    # 25-iteration bound; from scratch 5 iterations land far below it.
    assert s2["final_bound"] >= s1["final_bound"] - 1e-3
    s_cold = cli.main([a for a in argv] + ["-T", "5", "-s", str(tmp_path / "st2")])
    assert s2["final_bound"] > s_cold["final_bound"]


def test_cli_svgp_resume(tmp_path, rng):
    """--optimizer svgp + --load restores SVGPParams and continues training."""
    from gparml import cli

    x = rng.uniform(-2, 2, (200, 1))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal((200, 1))
    inputs = tmp_path / "inputs"
    emb = tmp_path / "emb"
    stats = tmp_path / "st"
    data.save_partitioned(str(inputs), y, 2, prefix="Y")
    data.save_embeddings(str(emb), x, np.full_like(x, 1e-6), n_partitions=2)
    argv = [
        "-i", str(inputs), "-e", str(emb), "-s", str(stats),
        "-T", "150", "-q", "1", "-m", "8", "--fixed-embeddings",
        "--optimizer", "svgp", "--batch-size", "64", "--learning-rate", "0.05",
    ]
    s1 = cli.main(argv)
    # argparse keeps the LAST occurrence of a repeated flag
    s2 = cli.main(argv + ["-T", "50", "--load"])
    assert s2["final_elbo"] >= s1["final_elbo"] - 25.0  # continues, no restart
    s_cold = cli.main(argv + ["-T", "50", "-s", str(tmp_path / "st2")])
    assert s2["final_elbo"] > s_cold["final_elbo"]


def test_cli_svgp_mode(tmp_path, rng):
    """--fixed-embeddings --optimizer svgp: minibatch stochastic training."""
    from gparml import cli

    x = rng.uniform(-2, 2, (200, 1))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal((200, 1))
    inputs = tmp_path / "inputs"
    emb = tmp_path / "emb"
    data.save_partitioned(str(inputs), y, 2, prefix="Y")
    data.save_embeddings(str(emb), x, np.full_like(x, 1e-6), n_partitions=2)
    summary = cli.main([
        "-i", str(inputs), "-e", str(emb), "-s", str(tmp_path / "st"),
        "-T", "200", "-q", "1", "-m", "10", "--fixed-embeddings",
        "--optimizer", "svgp", "--batch-size", "64", "--learning-rate", "0.05",
    ])
    assert summary["mode"] == "svgp"
    assert np.isfinite(summary["final_elbo"])


def test_cli_trace_timing_wall_column(tmp_path, rng):
    """--trace-timing: history rows carry REAL per-iteration wall clocks
    (the reference printed true per-iteration timings)."""
    from gparml import cli

    y, _ = data.synthetic_gplvm(n=40, d=4, q_true=1, seed=3)
    inputs = tmp_path / "inputs"
    stats = tmp_path / "statistics"
    data.save_partitioned(str(inputs), y, 2, prefix="Y")
    summary = cli.main([
        "-i", str(inputs), "-e", str(tmp_path / "emb"), "-s", str(stats),
        "-T", "8", "-q", "2", "-m", "5", "--trace-timing",
    ])
    assert np.isfinite(summary["final_bound"])
    with open(stats / "bound_history.jsonl") as f:
        lines = [json.loads(l) for l in f]
    assert lines
    for row in lines:
        assert "wall_s" in row
        assert row["wall_s"] > 0
    # stamps are real per-iteration clocks, not a uniform average
    walls = {row["wall_s"] for row in lines}
    assert len(walls) >= min(2, len(lines))


def test_cli_profile_writes_trace(tmp_path, rng):
    """--profile DIR: a jax.profiler (Perfetto/XProf) trace of the fit lands
    in DIR (SURVEY §5 tracing row — the device-timeline upgrade of the
    reference's per-pass wall-clock prints)."""
    from gparml import cli

    y, _ = data.synthetic_gplvm(n=40, d=4, q_true=1, seed=3)
    inputs = tmp_path / "inputs"
    trace_dir = tmp_path / "trace"
    data.save_partitioned(str(inputs), y, 2, prefix="Y")
    summary = cli.main([
        "-i", str(inputs), "-e", str(tmp_path / "emb"),
        "-s", str(tmp_path / "statistics"),
        "-T", "3", "-q", "2", "-m", "5", "--profile", str(trace_dir),
    ])
    assert np.isfinite(summary["final_bound"])
    produced = [p for p in trace_dir.rglob("*") if p.is_file()]
    assert produced, "profiler trace directory is empty"
