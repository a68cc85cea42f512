"""Partition invariance over mesh sizes {1, 2, 8} on the forced-8-device CPU
backend (SURVEY.md §4 item 3): the distributed bound/gradients must equal the
single-device ones to float tolerance because the map-reduce decomposition is
an exact sum — the reference validated this by running 1 vs k worker
processes; here it's 1 vs k mesh shards."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gparml.ops import bound, psi
from gparml.parallel import mesh as mesh_lib
from gparml.parallel import stats as pstats
from tests.conftest import make_problem


def _dist_bound(mesh, y, mu, s, z, sf2, alpha, beta, d, weights=None):
    st = pstats.suff_stats_sharded(
        y, mu, s, z, sf2, alpha, mesh=mesh, weights=weights
    )
    return bound.bound_from_stats(st, z, sf2, alpha, beta, d=d)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_stats_invariant_across_mesh_sizes(rng):
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=32, d=3, q=2, m=5)
    args = [jnp.asarray(a) for a in (y, mu, s, z)]
    alpha_j = jnp.asarray(alpha)

    ref = psi.suff_stats(args[0], args[1], args[2], args[3], sf2, alpha_j)
    for k in (1, 2, 8):
        m = mesh_lib.make_mesh(k)
        ys, mus, ss, w = mesh_lib.shard_data(m, y, mu, s)
        st = jax.jit(lambda mus_, ss_, z_: pstats.suff_stats_sharded(
            ys, mus_, ss_, z_, sf2, alpha_j, mesh=m, weights=w
        ))(mus, ss, args[3])
        for a, b in zip(ref, st):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-12)


def test_bound_and_grads_invariant_across_mesh_sizes(rng):
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=32, d=3, q=2, m=5)
    zj, alphaj = jnp.asarray(z), jnp.asarray(alpha)

    def ref_obj(zj, mu_, s_):
        st = psi.suff_stats(jnp.asarray(y), mu_, s_, zj, sf2, alphaj)
        return bound.bound_from_stats(st, zj, sf2, alphaj, beta, d=y.shape[1])

    f_ref, g_ref = jax.jit(jax.value_and_grad(ref_obj, argnums=(0, 1, 2)))(
        zj, jnp.asarray(mu), jnp.asarray(s)
    )

    for k in (2, 8):
        m = mesh_lib.make_mesh(k)
        ys, mus, ss, w = mesh_lib.shard_data(m, y, mu, s)

        def dist_obj(zj, mu_, s_):
            return _dist_bound(m, ys, mu_, s_, zj, sf2, alphaj, beta, y.shape[1], w)

        f, g = jax.jit(jax.value_and_grad(dist_obj, argnums=(0, 1, 2)))(zj, mus, ss)
        np.testing.assert_allclose(float(f), float(f_ref), rtol=1e-12)
        # grad wrt replicated Z (psum of per-shard partials) and sharded mu, s
        np.testing.assert_allclose(np.asarray(g[0]), np.asarray(g_ref[0]), rtol=1e-10)
        np.testing.assert_allclose(np.asarray(g[1]), np.asarray(g_ref[1]), rtol=1e-10)
        np.testing.assert_allclose(np.asarray(g[2]), np.asarray(g_ref[2]), rtol=1e-10)


def test_uneven_n_padding_is_exact(rng):
    """N=29 over 8 shards: ones-padding + 0/1 weights keeps stats exact."""
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=29, d=3, q=2, m=5)
    ref = psi.suff_stats(
        jnp.asarray(y), jnp.asarray(mu), jnp.asarray(s), jnp.asarray(z), sf2, jnp.asarray(alpha)
    )
    m = mesh_lib.make_mesh(8)
    ys, mus, ss, w = mesh_lib.shard_data(m, y, mu, s)
    assert ys.shape[0] == 32
    st = pstats.suff_stats_sharded(
        ys, mus, ss, jnp.asarray(z), sf2, jnp.asarray(alpha), mesh=m, weights=w
    )
    for a, b in zip(ref, st):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-12)
    assert float(st.n) == 29.0


def test_sgpr_mode_sharded(rng):
    y, x, _, z, sf2, alpha, beta = make_problem(rng, n=24, d=3, q=2, m=5, latent=False)
    ref = psi.suff_stats(
        jnp.asarray(y), jnp.asarray(x), None, jnp.asarray(z), sf2, jnp.asarray(alpha)
    )
    m = mesh_lib.make_mesh(8)
    ys, xs, w = mesh_lib.shard_data(m, y, x)
    st = pstats.suff_stats_sharded(
        ys, xs, None, jnp.asarray(z), sf2, jnp.asarray(alpha), mesh=m, weights=w
    )
    for a, b in zip(ref, st):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-12)


def test_blocked_scan_inside_shard_map(rng):
    """block (remat scan) composed with shard_map matches the dense path."""
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=64, d=3, q=2, m=5)
    ref = psi.suff_stats(
        jnp.asarray(y), jnp.asarray(mu), jnp.asarray(s), jnp.asarray(z), sf2, jnp.asarray(alpha)
    )
    m8 = mesh_lib.make_mesh(8)
    ys, mus, ss, w = mesh_lib.shard_data(m8, y, mu, s)
    st = pstats.suff_stats_sharded(
        ys, mus, ss, jnp.asarray(z), sf2, jnp.asarray(alpha),
        mesh=m8, weights=w, block=4,
    )
    for a, b in zip(ref, st):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-10)


def test_sgpr_blocked_scan_inside_shard_map(rng):
    """The SGPR (s=None) blocked K_NM scan composed with shard_map matches
    the dense path — the new blocked branch must honor vary_axis for the
    scan carry inside the manual-axes region."""
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=64, d=3, q=2, m=5)
    ref = psi.suff_stats(
        jnp.asarray(y), jnp.asarray(mu), None, jnp.asarray(z), sf2,
        jnp.asarray(alpha)
    )
    m8 = mesh_lib.make_mesh(8)
    ys, mus, _, w = mesh_lib.shard_data(m8, y, mu, s)
    st = pstats.suff_stats_sharded(
        ys, mus, None, jnp.asarray(z), sf2, jnp.asarray(alpha),
        mesh=m8, weights=w, block=4,
    )
    for a, b in zip(ref, st):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-10)


def test_sgpr_predict_under_mesh(rng):
    """predict with sharded training data matches the single-device result."""
    from gparml.models import sgpr

    x = np.sort(rng.uniform(-2, 2, (40, 1)), axis=0)
    y = np.sin(2 * x)
    cfg = sgpr.SGPRConfig(num_inducing=6)
    g0 = sgpr.init_params(jax.random.key(0), jnp.asarray(x), jnp.asarray(y), cfg)
    xs = jnp.linspace(-2, 2, 9)[:, None]
    mean_ref, var_ref = sgpr.predict(g0, jnp.asarray(x), jnp.asarray(y), xs, cfg)

    m8 = mesh_lib.make_mesh(8)
    ys, xsh, w = mesh_lib.shard_data(m8, y, x)
    mean, var = sgpr.predict(g0, xsh, ys, xs, cfg, mesh=m8, weights=w)
    np.testing.assert_allclose(np.asarray(mean), np.asarray(mean_ref), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(var), np.asarray(var_ref), rtol=1e-8)


def test_stepped_scg_matches_fused_under_mesh(rng):
    """The host-stepped SCG driver (the config-5-scale mode) under a data
    mesh: sharded latents/data ride the per-iteration programs unchanged,
    and the trajectory matches the fused while_loop driver."""
    from gparml.models import gplvm
    from gparml.models import params as P

    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=24, d=3, q=2, m=5)
    m8 = mesh_lib.make_mesh(8)
    ys, mus, ss, w = mesh_lib.shard_data(m8, y, mu, s)
    lat = P.make_latents(mus, ss, bijector="exp")
    glob = P.make_global(jnp.asarray(z), sf2, alpha, beta)
    p0 = P.GPLVMParams(glob=glob, lat=lat)

    hists = {}
    for mode in ("fused", "stepped"):
        cfg = gplvm.GPLVMConfig(q=2, num_inducing=5, scg_mode=mode)
        res = gplvm.fit(p0, ys, cfg, iters=6, mesh=m8, weights=w)
        h = np.asarray(res.history)
        hists[mode] = h[np.isfinite(h)]
        assert hists[mode].size > 0
    k = min(len(hists["fused"]), len(hists["stepped"]))
    np.testing.assert_allclose(hists["fused"][:k], hists["stepped"][:k],
                               rtol=1e-6)


@pytest.mark.parametrize("requested,platform,dtype,latent,want", [
    ("auto", "gpu", jnp.float32, True, "gpu"),
    ("auto", "gpu", jnp.float64, True, "xla"),   # float64: the reference engine
    ("auto", "gpu", jnp.float32, False, "xla"),  # SGPR statistics
    ("auto", "cpu", jnp.float32, True, "xla"),
    ("xla", "gpu", jnp.float32, True, "xla"),
    ("gpu", "gpu", jnp.float32, True, "gpu"),
])
def test_choose_engine(requested, platform, dtype, latent, want):
    assert pstats.choose_engine(requested, dtype, latent=latent,
                                platform=platform) == want


@pytest.mark.parametrize("requested,platform,dtype,match", [
    ("gpu", "cpu", jnp.float32, "needs a GPU"),
    ("gpu", "gpu", jnp.float64, "float32"),
    ("pallas", "gpu", jnp.float32, "unknown psi engine"),
])
def test_choose_engine_refuses(requested, platform, dtype, match):
    """An explicit GPU request off the GPU (or in float64) is an error; it
    never falls back to the Pallas interpreter."""
    with pytest.raises(ValueError, match=match):
        pstats.choose_engine(requested, dtype, platform=platform)


def test_gpu_engine_off_gpu_raises_through_model(rng):
    """stats_impl='gpu' on this (CPU) backend fails at trace time, single
    device and under a mesh."""
    from gparml.models import gplvm

    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=16, d=2, q=2, m=4)
    cfg = gplvm.GPLVMConfig(q=2, num_inducing=4, stats_impl="gpu")
    p = gplvm.init_params(jax.random.key(0), jnp.asarray(y, jnp.float32), cfg)
    with pytest.raises(ValueError, match="needs a GPU"):
        gplvm.log_bound(p, jnp.asarray(y, jnp.float32), cfg)
    m8 = mesh_lib.make_mesh(8)
    ys, mus, ss, w = mesh_lib.shard_data(m8, y, mu, s)
    with pytest.raises(ValueError, match="needs a GPU"):
        pstats.suff_stats_sharded(ys, mus, ss, jnp.asarray(z), sf2,
                                  jnp.asarray(alpha), mesh=m8, weights=w,
                                  impl="gpu")
