"""End-to-end model tests: SGPR hyperparameter recovery (BASELINE config 1)
and GPLVM latent-structure recovery with SCG (BASELINE config 2 shape,
small sizes for CI speed). SURVEY.md §4 e2e plan."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gparml import data
from gparml.models import gplvm, sgpr
from gparml.models import params as P


def test_sgpr_recovers_noise_and_fits():
    rng = np.random.default_rng(3)
    n, m = 200, 12
    x = np.sort(rng.uniform(-3, 3, (n, 1)), axis=0)
    true_beta = 25.0
    y = np.sin(2.0 * x) + rng.standard_normal((n, 1)) / np.sqrt(true_beta)

    cfg = sgpr.SGPRConfig(num_inducing=m)
    g0 = sgpr.init_params(jax.random.key(0), jnp.asarray(x), jnp.asarray(y), cfg)
    res = sgpr.fit(g0, jnp.asarray(x), jnp.asarray(y), cfg, iters=150)

    hist = np.asarray(res.history)
    hist = hist[np.isfinite(hist)]
    assert hist[-1] > hist[0] + 10.0  # bound increased substantially
    _, _, _, beta = P.constrain(res.params)
    assert 10.0 < float(beta) < 60.0  # noise precision in the right ballpark

    mean, var = sgpr.predict(res.params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(x), cfg)
    rmse = float(np.sqrt(np.mean((np.asarray(mean) - np.sin(2.0 * x)) ** 2)))
    assert rmse < 0.1


def test_sgpr_adam_also_improves():
    rng = np.random.default_rng(4)
    x = rng.uniform(-2, 2, (100, 1))
    y = np.cos(x) + 0.1 * rng.standard_normal((100, 1))
    cfg = sgpr.SGPRConfig(num_inducing=8)
    g0 = sgpr.init_params(jax.random.key(1), jnp.asarray(x), jnp.asarray(y), cfg)
    res = sgpr.fit(g0, jnp.asarray(x), jnp.asarray(y), cfg, iters=200, optimizer="adam", learning_rate=5e-2)
    hist = np.asarray(res.history)
    assert hist[-1] > hist[0]


def test_gplvm_scg_increases_bound_and_finds_structure():
    """Oil-flow-style run (scaled down): low-dim latent data embedded in D dims;
    the ARD precisions of unused latent dimensions should shrink."""
    rng = np.random.default_rng(5)
    n, d, q_true, q_model = 80, 6, 1, 3
    t = rng.standard_normal((n, q_true))
    w = rng.standard_normal((q_true, d))
    y = np.tanh(t @ w) + 0.05 * rng.standard_normal((n, d))
    y = (y - y.mean(0)) / y.std(0)

    cfg = gplvm.GPLVMConfig(q=q_model, num_inducing=15)
    p0 = gplvm.init_params(jax.random.key(2), jnp.asarray(y), cfg)
    res = gplvm.fit(p0, jnp.asarray(y), cfg, iters=120)

    hist = np.asarray(res.history)
    hist = hist[np.isfinite(hist)]
    assert hist[-1] > hist[0] + 10.0
    assert np.all(np.diff(hist) >= -1e-9)  # SCG accepted-step monotonicity

    # ARD: at least one latent dimension should carry much more signal
    _, _, alpha, _ = P.constrain(res.params.glob)
    alpha = np.sort(np.asarray(alpha))
    assert alpha[-1] > 3.0 * alpha[0]


def test_fit_scg_mode_stepped_matches_fused():
    """scg_mode='stepped' (one device program per SCG iteration — the
    config-5-scale driver, scg.STEPPED_N_THRESHOLD note) is trajectory-
    identical to the fused while_loop on both model families."""
    rng = np.random.default_rng(11)
    y = rng.standard_normal((48, 4))
    cfg_f = gplvm.GPLVMConfig(q=2, num_inducing=8, scg_mode="fused")
    cfg_s = gplvm.GPLVMConfig(q=2, num_inducing=8, scg_mode="stepped")
    p0 = gplvm.init_params(jax.random.key(7), jnp.asarray(y), cfg_f)
    rf = gplvm.fit(p0, jnp.asarray(y), cfg_f, iters=8)
    rs = gplvm.fit(p0, jnp.asarray(y), cfg_s, iters=8)
    np.testing.assert_allclose(
        np.asarray(rf.history), np.asarray(rs.history), rtol=1e-6)

    x = rng.uniform(-2, 2, (60, 1))
    ys = np.cos(x) + 0.1 * rng.standard_normal((60, 1))
    scfg_f = sgpr.SGPRConfig(num_inducing=6, scg_mode="fused")
    scfg_s = sgpr.SGPRConfig(num_inducing=6, scg_mode="stepped")
    g0 = sgpr.init_params(jax.random.key(8), jnp.asarray(x), jnp.asarray(ys), scfg_f)
    sf = sgpr.fit(g0, jnp.asarray(x), jnp.asarray(ys), scfg_f, iters=8)
    ss = sgpr.fit(g0, jnp.asarray(x), jnp.asarray(ys), scfg_s, iters=8)
    np.testing.assert_allclose(
        np.asarray(sf.history), np.asarray(ss.history), rtol=1e-6)


def test_gplvm_fixed_embeddings_keeps_latents():
    rng = np.random.default_rng(6)
    y = rng.standard_normal((40, 4))
    cfg = gplvm.GPLVMConfig(q=2, num_inducing=8, fixed_embeddings=True)
    p0 = gplvm.init_params(jax.random.key(3), jnp.asarray(y), cfg)
    res = gplvm.fit(p0, jnp.asarray(y), cfg, iters=30)
    np.testing.assert_array_equal(res.params.lat.mu, p0.lat.mu)
    np.testing.assert_array_equal(res.params.lat.u_s, p0.lat.u_s)


def test_gplvm_fixed_beta():
    rng = np.random.default_rng(7)
    y = rng.standard_normal((40, 4))
    cfg = gplvm.GPLVMConfig(q=2, num_inducing=8, fixed_beta=True)
    p0 = gplvm.init_params(jax.random.key(4), jnp.asarray(y), cfg)
    res = gplvm.fit(p0, jnp.asarray(y), cfg, iters=30)
    np.testing.assert_array_equal(res.params.glob.u_beta, p0.glob.u_beta)
    assert not np.array_equal(res.params.glob.z, p0.glob.z)


def test_gplvm_infer_latents_and_reconstruct():
    """Held-out observations: inferred latents should reconstruct them much
    better than the training-mean baseline (Bayesian-GPLVM test inference)."""
    rng = np.random.default_rng(8)
    n, n_test, d = 120, 10, 6
    t = rng.standard_normal((n + n_test, 1))
    w = rng.standard_normal((1, d))
    y_all = np.tanh(t @ w) + 0.05 * rng.standard_normal((n + n_test, d))
    y_all = (y_all - y_all.mean(0)) / y_all.std(0)
    y_tr, y_te = jnp.asarray(y_all[:n]), jnp.asarray(y_all[n:])

    cfg = gplvm.GPLVMConfig(q=2, num_inducing=12)
    p0 = gplvm.init_params(jax.random.key(5), y_tr, cfg)
    res = gplvm.fit(p0, y_tr, cfg, iters=120)

    mu_s, s_s, inf = gplvm.infer_latents(res.params, y_tr, y_te, cfg, iters=60)
    assert mu_s.shape == (n_test, 2)
    assert np.all(np.asarray(s_s) > 0)
    hist = np.asarray(inf.history)
    hist = hist[np.isfinite(hist)]
    assert hist[-1] >= hist[0]  # joint bound improves over the NN init

    mean, var = gplvm.reconstruct(res.params, y_tr, mu_s, s_s, cfg)
    rmse = float(np.sqrt(np.mean((np.asarray(mean) - np.asarray(y_te)) ** 2)))
    baseline = float(np.sqrt(np.mean(np.asarray(y_te) ** 2)))  # mean-zero data
    assert rmse < 0.5 * baseline
    assert np.all(np.asarray(var) > 0)


def test_fit_shape_validation():
    rng = np.random.default_rng(9)
    y = jnp.asarray(rng.standard_normal((20, 3)))
    cfg = gplvm.GPLVMConfig(q=2, num_inducing=5)
    p0 = gplvm.init_params(jax.random.key(0), y, cfg)
    import pytest
    with pytest.raises(ValueError, match="N="):
        gplvm.fit(p0, y[:10], cfg, iters=1)
    with pytest.raises(ValueError, match="config.q"):
        bad = gplvm.GPLVMConfig(q=3, num_inducing=5)
        gplvm.fit(p0, y, bad, iters=1)


def test_sgpr_f32_fit_matches_f64_optimum():
    """float32 SCG fit convergence — the production dtype. Before the
    bound's anti-runaway clamps (ops/bound.py) this exact fit diverged to
    beta ~ 2.2e4 / F ~ +5e9 by climbing an ill-conditioning artifact of the
    f32 trace term; with them it must land at the float64 optimum."""
    rng = np.random.default_rng(0)
    n, m = 400, 12
    x = np.sort(rng.uniform(-3, 3, (n, 1)), axis=0).astype(np.float32)
    y = (np.sin(1.5 * x) + 0.2 * rng.standard_normal((n, 1))).astype(np.float32)

    cfg = sgpr.SGPRConfig(num_inducing=m)
    g0 = sgpr.init_params(jax.random.key(0), jnp.asarray(x), jnp.asarray(y), cfg)
    assert g0.z.dtype == jnp.float32
    res = sgpr.fit(g0, jnp.asarray(x), jnp.asarray(y), cfg, iters=120)

    hist = np.asarray(res.history)
    hist = hist[np.isfinite(hist)]
    assert hist[-1] > hist[0]
    _, sf2, _, beta = P.constrain(res.params)
    assert 10.0 < float(beta) < 80.0, float(beta)   # true 25; runaway was 2e4
    assert float(sf2) < 50.0, float(sf2)            # runaway was ~1e3
    mean, _ = sgpr.predict(res.params, jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(x[:50]), cfg)
    rmse = float(np.sqrt(np.mean((np.asarray(mean) - np.sin(1.5 * x[:50])) ** 2)))
    assert rmse < 0.15, rmse


def test_gplvm_qn_layout_matches_nq(rng):
    """layout='qn' (transposed (Q, N) latent storage — the single-chip
    large-N affordance, docs/DESIGN.md §5) is numerically identical to the
    default layout: same bound, same gradients (transposed)."""
    y, _ = data.synthetic_gplvm(n=40, d=4, q_true=2, seed=4)
    yj = jnp.asarray(y)
    cfg_nq = gplvm.GPLVMConfig(q=2, num_inducing=6)
    cfg_qn = gplvm.GPLVMConfig(q=2, num_inducing=6, layout="qn")
    p_nq = gplvm.init_params(jax.random.key(0), yj, cfg_nq)
    p_qn = gplvm.init_params(jax.random.key(0), yj, cfg_qn)
    assert p_qn.lat.mu.shape == (2, 40)
    np.testing.assert_allclose(np.asarray(p_qn.lat.mu),
                               np.asarray(p_nq.lat.mu).T, rtol=1e-12)

    f_nq, g_nq = jax.jit(lambda p, y: gplvm.neg_bound_value_and_grad(p, y, cfg_nq))(p_nq, yj)
    f_qn, g_qn = jax.jit(lambda p, y: gplvm.neg_bound_value_and_grad(p, y, cfg_qn))(p_qn, yj)
    np.testing.assert_allclose(float(f_qn), float(f_nq), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g_qn.lat.mu),
                               np.asarray(g_nq.lat.mu).T, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(g_qn.glob.z),
                               np.asarray(g_nq.glob.z), rtol=1e-10)

    res = gplvm.fit(p_qn, yj, cfg_qn, iters=10)
    h = np.asarray(res.history)
    h = h[np.isfinite(h)]
    assert h[-1] >= h[0] - 1e-6
    mu_nat, s_nat = gplvm.latents(res.params, cfg_qn)
    assert mu_nat.shape == (40, 2) and s_nat.shape == (40, 2)

    # mesh + qn is rejected (the sharded path owns (N, Q) rows)
    from gparml.parallel import mesh as mesh_lib
    with pytest.raises(ValueError):
        gplvm.fit(p_qn, yj, cfg_qn, iters=1, mesh=mesh_lib.make_mesh(2))


def test_cli_qn_layout_end_to_end(tmp_path, rng):
    from gparml import cli

    y, _ = data.synthetic_gplvm(n=48, d=5, q_true=1, seed=12)
    inputs = tmp_path / "inputs"
    data.save_partitioned(str(inputs), y, 3, prefix="Y")
    argv = ["-i", str(inputs), "-e", str(tmp_path / "emb"),
            "-s", str(tmp_path / "st"), "-T", "10", "-q", "2", "-m", "6",
            "--layout", "qn"]
    s1 = cli.main(argv)
    assert np.isfinite(s1["final_bound"])
    mu = np.load(tmp_path / "emb" / "X_mu_0.npy")
    assert mu.shape[1] == 2  # embeddings saved in the (N, Q) file contract
    s2 = cli.main(argv + ["--load"])
    assert s2["final_bound"] >= s1["final_bound"] - 1e-3
