"""(Q, N)-native ("transposed layout") psi statistics and model path.

The layout stores latents/inputs (Q, N) and observations (D, N) on a single
device. These tests pin the transposed blocked scan (psi.suff_stats_t) to
the row-major engine (values AND grads) and the model-level dispatch
(GPLVMConfig layout='qn', y_layout='dn').

Reference scope: GParML has no analogue (flat NumPy is layout-free);
this is memory-layout engineering on top of the same math
(SURVEY.md Appendix A).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gparml.models import gplvm


def _data(n, q, d, m, seed=0):
    rng = np.random.default_rng(seed)
    mu = jnp.asarray(rng.standard_normal((n, q)), jnp.float32)
    s = jnp.asarray(rng.uniform(0.2, 1.5, (n, q)), jnp.float32)
    y = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    z = jnp.asarray(rng.standard_normal((m, q)), jnp.float32)
    al = jnp.asarray(rng.uniform(0.5, 2.0, (q,)), jnp.float32)
    w = jnp.asarray(rng.uniform(0.5, 1.5, (n,)), jnp.float32)
    return mu, s, y, z, al, w


def _loss(st, m):
    probe = jnp.cos(jnp.arange(m)[:, None] + jnp.arange(m)[None, :])
    return (jnp.sum(st.psi1_y ** 2) + jnp.sum(st.psi2 * probe)
            + st.psi0 + st.yy + st.kl)


def test_gplvm_qn_native_bound_and_fit():
    """Model-level dispatch: layout='qn' + y_layout='dn' must reproduce the
    row-major bound/gradients from identical parameters and train."""
    rng = np.random.default_rng(1)
    n, d, q, m = 96, 6, 4, 130
    y = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    key = jax.random.PRNGKey(0)

    cfg_nq = gplvm.GPLVMConfig(q=q, num_inducing=m)
    p_nq = gplvm.init_params(key, y, cfg_nq)

    cfg_qn = gplvm.GPLVMConfig(q=q, num_inducing=m, layout="qn", y_layout="dn")
    p_qn = gplvm.init_params(key, y.T, cfg_qn)

    # value_and_grad gives the bound too
    v_nq, g_nq = jax.jit(lambda p, y: gplvm.neg_bound_value_and_grad(p, y, cfg_nq))(p_nq, y)
    v_qn, g_qn = jax.jit(lambda p, y: gplvm.neg_bound_value_and_grad(p, y, cfg_qn))(p_qn, y.T)
    b_qn = -v_qn
    # f32 + different accumulation orders between the two layouts: observed
    # up to ~2e-6 relative on the bound (shape-dependent)
    np.testing.assert_allclose(float(v_nq), float(v_qn), rtol=5e-6)
    # The two layouts accumulate in different orders, so compare at
    # gradient SCALE.
    g1 = np.asarray(g_nq.lat.mu)
    np.testing.assert_allclose(np.asarray(g_qn.lat.mu), g1.T,
                               atol=3e-3 * np.max(np.abs(g1)))
    gz = np.asarray(g_nq.glob.z)
    np.testing.assert_allclose(np.asarray(g_qn.glob.z), gz,
                               atol=3e-3 * np.max(np.abs(gz)))

    # 2 iterations: enough to prove the qn fit loop runs and does not regress
    # the bound (trajectory parity is covered above at the gradient level)
    res = gplvm.fit(p_qn, y.T, cfg_qn, iters=2)
    assert np.isfinite(float(res.bound))
    assert float(res.bound) >= float(b_qn) - 1e-3


@pytest.mark.parametrize("block", [None, 50])
def test_psi_suff_stats_t_blocked_scan(block):
    """The (Q, N)-native blocked XLA scan (psi.suff_stats_t) matches the
    row-major engine in values AND grads."""
    from gparml.ops import psi

    q, d, m, n = 4, 3, 25, 200
    mu, s, y, z, al, w = _data(n, q, d, m, seed=7)
    sf2 = jnp.float32(1.3)

    def f_nq(args):
        mu, s, y, z, sf2, al = args
        st = psi.suff_stats(y, mu, s, z, sf2, al, weights=w, block=block)
        return _loss(st, m)

    def f_qn(args):
        mu, s, y, z, sf2, al = args
        st = psi.suff_stats_t(y.T, mu.T, s.T, z, sf2, al, weights=w,
                              block=block)
        return _loss(st, m)

    args = (mu, s, y, z, sf2, al)
    v1, g1 = jax.jit(jax.value_and_grad(f_nq))(args)
    v2, g2 = jax.jit(jax.value_and_grad(f_qn))(args)
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-6)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5,
                                   atol=1e-6 * float(jnp.max(jnp.abs(a))))


def test_gplvm_qn_large_m_routes_to_transposed_scan():
    """Large M with layout='qn' must stay correct (and must NOT
    whole-array-transpose: the dispatch goes through psi.suff_stats_t).
    Model-level parity against the row-major XLA path."""
    rng = np.random.default_rng(9)
    n, d, q, m = 64, 4, 3, 700
    y = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    key = jax.random.PRNGKey(2)
    cfg_nq = gplvm.GPLVMConfig(q=q, num_inducing=m, stats_impl="xla")
    cfg_qn = gplvm.GPLVMConfig(q=q, num_inducing=m, layout="qn",
                               y_layout="dn", block=32)
    p_nq = gplvm.init_params(key, y, cfg_nq)
    p_qn = gplvm.init_params(key, y.T, cfg_qn)
    # f32 accumulation order differs (block=32 transposed scan vs one-shot
    # XLA): observed up to ~1e-6 relative on the bound
    np.testing.assert_allclose(
        float(jax.jit(lambda p, yy: gplvm.log_bound(p, yy, cfg_nq))(p_nq, y)),
        float(jax.jit(lambda p, yy: gplvm.log_bound(p, yy, cfg_qn))(p_qn, y.T)),
        rtol=5e-6)
    _, g_nq = jax.jit(lambda p, y: gplvm.neg_bound_value_and_grad(p, y, cfg_nq))(p_nq, y)
    _, g_qn = jax.jit(lambda p, y: gplvm.neg_bound_value_and_grad(p, y, cfg_qn))(p_qn, y.T)
    # stats agree to ~1e-6 (f32 block-order), but M=700 random-Z solves
    # amplify that through A^-1 conditioning: compare at gradient scale
    g1 = np.asarray(g_nq.lat.mu)
    np.testing.assert_allclose(np.asarray(g_qn.lat.mu), g1.T,
                               atol=3e-3 * np.max(np.abs(g1)))


@pytest.mark.parametrize("block", [None, 25])
def test_sgpr_suff_stats_blocked_and_transposed(block):
    """SGPR (s=None) statistics: the blocked row-major scan and the
    (Q, N)-native scan both match the one-shot K_NM products (values and
    grads) — K_NM never materializes beyond one (block, M) slab."""
    from gparml.ops import psi

    q, d, m, n = 3, 2, 15, 100
    mu, _, y, z, al, w = _data(n, q, d, m, seed=11)
    sf2 = jnp.float32(0.8)

    def f_ref(args):
        mu, y, z, sf2, al = args
        st = psi.suff_stats(y, mu, None, z, sf2, al, weights=w)
        return _loss(st, m)

    def f_blocked(args):
        mu, y, z, sf2, al = args
        st = psi.suff_stats(y, mu, None, z, sf2, al, weights=w, block=block)
        return _loss(st, m)

    def f_qn(args):
        mu, y, z, sf2, al = args
        st = psi.suff_stats_t(y.T, mu.T, None, z, sf2, al, weights=w,
                              block=block)
        return _loss(st, m)

    args = (mu, y, z, sf2, al)
    v0, g0 = jax.jit(jax.value_and_grad(f_ref))(args)
    for f in (f_blocked, f_qn):
        v, g = jax.jit(jax.value_and_grad(f))(args)
        np.testing.assert_allclose(float(v), float(v0), rtol=1e-6)
        for a, b in zip(g, g0):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-5,
                                       atol=1e-6 * float(jnp.max(jnp.abs(b))))


def test_sgpr_qn_layout_model_level():
    """SGPR with layout='qn' (x (Q,N), y (D,N)) reproduces the row-major
    bound/fit — the regression-mode analogue of the GPLVM qn affordance."""
    from gparml.models import sgpr

    rng = np.random.default_rng(13)
    n, q, d, m = 120, 2, 3, 18
    x = rng.standard_normal((n, q)).astype(np.float32)
    w = rng.standard_normal((q, d)).astype(np.float32)
    y = (x @ w + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    cfg = sgpr.SGPRConfig(num_inducing=m)
    cfg_qn = sgpr.SGPRConfig(num_inducing=m, layout="qn", block=30)
    g0 = sgpr.init_params(jax.random.key(0), xj, yj, cfg)
    g0_qn = sgpr.init_params(jax.random.key(0), xj.T, yj.T, cfg_qn)
    np.testing.assert_allclose(np.asarray(g0.z), np.asarray(g0_qn.z),
                               rtol=1e-6)
    b_nq = float(sgpr.log_bound(g0, xj, yj, cfg))
    b_qn = float(sgpr.log_bound(g0_qn, xj.T, yj.T, cfg_qn))
    # statistics agree to 1e-6 (pinned above); A^-1 solve conditioning
    # amplifies the f32 block-order noise ~10x at the bound level
    np.testing.assert_allclose(b_nq, b_qn, rtol=1e-4)

    res = sgpr.fit(g0_qn, xj.T, yj.T, cfg_qn, iters=10)
    assert np.isfinite(float(res.bound))
    assert float(res.bound) >= b_qn - 1e-3

    xs = jnp.asarray(rng.standard_normal((7, q)), jnp.float32)
    m1, v1 = sgpr.predict(g0, xj, yj, xs, cfg)
    m2, v2 = sgpr.predict(g0_qn, xj.T, yj.T, xs, cfg_qn)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-4)

    # mesh + qn rejected
    from gparml.parallel import mesh as mesh_lib
    with pytest.raises(ValueError):
        sgpr.log_bound(g0_qn, xj.T, yj.T, cfg_qn,
                       mesh=mesh_lib.make_mesh(2))


def test_gplvm_qn_predict_and_infer_latents():
    """The prediction-side API under the transposed layout: predict_observed
    and infer_latents (+ reconstruct) match the row-major results from the
    same trained parameters."""
    rng = np.random.default_rng(21)
    n, d, q, m = 90, 5, 2, 20
    y = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    y_new = y[:6] + 0.01
    key = jax.random.PRNGKey(3)

    cfg = gplvm.GPLVMConfig(q=q, num_inducing=m, stats_impl="xla")
    cfg_qn = gplvm.GPLVMConfig(q=q, num_inducing=m, stats_impl="xla",
                               layout="qn", y_layout="dn", block=30)
    p = gplvm.init_params(key, y, cfg)
    p_qn = gplvm.init_params(key, y.T, cfg_qn)

    xs = jnp.asarray(rng.standard_normal((4, q)), jnp.float32)
    m1, v1 = gplvm.predict_observed(p, y, xs, cfg)
    m2, v2 = gplvm.predict_observed(p_qn, y.T, xs, cfg_qn)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-4)

    # SCG trajectories amplify f32 block-order noise — compare OUTCOMES
    # (inference bound, reconstruction error), not raw latent coordinates.
    mu1, s1, inf1 = gplvm.infer_latents(p, y, y_new, cfg, iters=8)
    mu2, s2, inf2 = gplvm.infer_latents(p_qn, y.T, y_new.T, cfg_qn, iters=8)
    assert mu2.shape == (6, q) and float(jnp.min(s2)) > 0
    np.testing.assert_allclose(float(inf1.bound), float(inf2.bound),
                               rtol=1e-3)

    r1, _ = gplvm.reconstruct(p, y, mu1, s1, cfg)
    r2, _ = gplvm.reconstruct(p_qn, y.T, mu2, s2, cfg_qn)
    e1 = float(jnp.sqrt(jnp.mean((r1 - y_new) ** 2)))
    e2 = float(jnp.sqrt(jnp.mean((r2 - y_new) ** 2)))
    assert abs(e1 - e2) < 0.15 * max(e1, 1e-3), (e1, e2)


def test_svgp_qn_layout_matches_nq():
    """SVGP with layout='qn' draws IDENTICAL minibatches (same key, same
    permutation, windows transposed from the lane axis), so the training
    trajectory matches the row-major run to f32 noise."""
    from gparml.models import svgp

    rng = np.random.default_rng(17)
    n, q, d, m = 300, 2, 3, 12
    x = rng.standard_normal((n, q)).astype(np.float32)
    w = rng.standard_normal((q, d)).astype(np.float32)
    y = (x @ w + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    cfg = svgp.SVGPConfig(num_inducing=m, batch_size=64)
    cfg_qn = svgp.SVGPConfig(num_inducing=m, batch_size=64, layout="qn")
    key = jax.random.key(5)
    p0 = svgp.init_params(key, xj, yj, cfg)
    p0_qn = svgp.init_params(key, xj.T, yj.T, cfg_qn)
    np.testing.assert_allclose(np.asarray(p0.glob.z),
                               np.asarray(p0_qn.glob.z), rtol=1e-6)

    r1 = svgp.fit(p0, xj, yj, cfg, steps=25, key=jax.random.key(9))
    r2 = svgp.fit(p0_qn, xj.T, yj.T, cfg_qn, steps=25, key=jax.random.key(9))
    h1, h2 = np.asarray(r1.history), np.asarray(r2.history)
    np.testing.assert_allclose(h2, h1, rtol=1e-4,
                               atol=1e-5 * np.max(np.abs(h1)))
    np.testing.assert_allclose(float(r2.elbo), float(r1.elbo), rtol=1e-4)

    # mesh + qn rejected
    from gparml.parallel import mesh as mesh_lib
    with pytest.raises(ValueError):
        svgp.fit(p0_qn, xj.T, yj.T, cfg_qn, steps=1,
                 mesh=mesh_lib.make_mesh(2))


def test_cli_qn_sgpr_and_svgp(tmp_path):
    """--layout qn now applies to the --fixed-embeddings modes too: the CLI
    transposes X/Y host-side and routes through SGPRConfig/SVGPConfig
    layout='qn'. Same folders, same bound scale as the row-major run."""
    from gparml import cli, data

    rng = np.random.default_rng(23)
    n = 120
    x = np.sort(rng.uniform(-2, 2, (n, 1)), axis=0).astype(np.float64)
    y = (np.sin(2 * x) + 0.1 * rng.standard_normal((n, 1))).astype(np.float64)
    inputs, emb = tmp_path / "inputs", tmp_path / "emb"
    data.save_partitioned(str(inputs), y, 3, prefix="Y")
    data.save_embeddings(str(emb), x, np.full_like(x, 1e-6), n_partitions=3)
    base = ["-i", str(inputs), "-e", str(emb),
            "-q", "1", "-m", "12", "--fixed-embeddings", "-T", "8"]

    # T=0: one bound evaluation at the (identical, FPS-deterministic) init
    # — exact parity check; training trajectories would diverge (the nq run
    # uses the 8-device mesh, qn is single-device: different sum orders
    # flip SCG accept decisions within a few iterations).
    b_nq = cli.main(base + ["-s", str(tmp_path / "st1"), "-T", "0",
                            "--dtype", "float64"])
    b_qn = cli.main(base + ["-s", str(tmp_path / "st2"), "-T", "0",
                            "--layout", "qn", "--dtype", "float64"])
    np.testing.assert_allclose(b_qn["final_bound"], b_nq["final_bound"],
                               rtol=1e-9)

    s_qn = cli.main(base + ["-s", str(tmp_path / "st4"), "--layout", "qn"])
    assert s_qn["mode"] == "sgpr"
    assert np.isfinite(s_qn["final_bound"])
    assert s_qn["final_bound"] >= b_qn["final_bound"]

    s_v = cli.main(base + ["-s", str(tmp_path / "st3"), "--layout", "qn",
                           "--optimizer", "svgp", "-T", "30",
                           "--batch-size", "48"])
    assert s_v["mode"] == "svgp" and np.isfinite(s_v["final_elbo"])


def test_gplvm_qn_xla_engine_transposes():
    """stats_impl='xla' with qn storage takes the documented transpose path
    and still matches."""
    rng = np.random.default_rng(2)
    n, d, q, m = 80, 5, 3, 20
    y = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    key = jax.random.PRNGKey(4)
    cfg_nq = gplvm.GPLVMConfig(q=q, num_inducing=m, stats_impl="xla")
    cfg_qn = gplvm.GPLVMConfig(q=q, num_inducing=m, stats_impl="xla",
                               layout="qn", y_layout="dn")
    p_nq = gplvm.init_params(key, y, cfg_nq)
    p_qn = gplvm.init_params(key, y.T, cfg_qn)
    np.testing.assert_allclose(
        float(gplvm.log_bound(p_nq, y, cfg_nq)),
        float(gplvm.log_bound(p_qn, y.T, cfg_qn)), rtol=1e-6)


def test_mesh_rejects_qn_layout_all_families():
    """mesh x layout='qn' is DEFINED at the API level for every model
    family: the transposed layout is the single-device large-N affordance; the sharded path owns (N, Q) rows, so fit()/_stats raise a
    ValueError naming the fallback instead of silently mis-sharding.
    (SVGP's rejection is also pinned inside test_svgp_qn_matches_row_major.)"""
    from gparml.models import sgpr, svgp
    from gparml.parallel import mesh as mesh_lib

    rng = np.random.default_rng(7)
    n, d, q, m = 32, 2, 2, 6
    y = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    x = jnp.asarray(rng.standard_normal((n, q)), jnp.float32)
    mesh2 = mesh_lib.make_mesh(2)

    cfg_g = gplvm.GPLVMConfig(q=q, num_inducing=m, layout="qn", y_layout="dn")
    p_g = gplvm.init_params(jax.random.key(0), y.T, cfg_g)
    with pytest.raises(ValueError, match="layout='qn'"):
        gplvm.fit(p_g, y.T, cfg_g, iters=1, mesh=mesh2)

    cfg_s = sgpr.SGPRConfig(num_inducing=m, layout="qn")
    g_s = sgpr.init_params(jax.random.key(0), x.T, y.T, cfg_s)
    with pytest.raises(ValueError, match="layout='qn'"):
        sgpr.fit(g_s, x.T, y.T, cfg_s, iters=1, mesh=mesh2)

    cfg_v = svgp.SVGPConfig(num_inducing=m, layout="qn", batch_size=16)
    p_v = svgp.init_params(jax.random.key(0), x.T, y.T, cfg_v)
    with pytest.raises(ValueError, match="layout='qn'"):
        svgp.fit(p_v, x.T, y.T, cfg_v, steps=1, mesh=mesh2)
