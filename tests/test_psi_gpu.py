"""The fused GPU psi kernels (ops/psi_gpu.py) against the XLA engine
(ops/psi.py) in float64: forward, weighted, ragged N, M that is not a tile
multiple, two Q values, and the backward pass. On the CPU the kernels run in
the Pallas interpreter (``interpret=True``); the ``gpu`` case compiles them
for the card."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from gparml.ops import psi, psi_gpu
from tests.conftest import make_problem

F = jnp.float32

# float32 kernels against float64 truth: the statistics are sums of
# positive terms, each with an exponent of magnitude up to ~10, so float32
# rounding leaves ~1e-6 relative error; 2e-5 leaves room for the sum order.
VALUE_RTOL = 2e-5
# gradients mix signs, so they are compared at the scale of their largest
# entry
GRAD_ATOL = 2e-5

# (n, q, m): small, ragged N (not a multiple of the 64-row step), M whose
# pair count is not a multiple of the 64-pair tile, and a second Q (whose
# 2Q + 2 features pad to 32 instead of 16).
CASES = [(24, 2, 5), (203, 3, 7), (70, 6, 17)]
IDS = ["small", "ragged_n", "q6_m17"]


def _problem(n, q, m, seed=0):
    rng = np.random.default_rng(seed)
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=n, d=3, q=q, m=m)
    w = rng.uniform(0.0, 1.0, n)
    return y, mu, s, z, sf2, alpha, w


def _f32(*xs):
    return tuple(jnp.asarray(x, F) for x in xs)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("n,q,m", CASES, ids=IDS)
def test_forward_parity(n, q, m, weighted):
    y, mu, s, z, sf2, alpha, w = _problem(n, q, m)
    w = w if weighted else None
    ref = psi.suff_stats(y, mu, s, z, sf2, alpha, weights=w)
    got = psi_gpu.suff_stats(*_f32(y, mu, s, z, sf2, alpha),
                             weights=None if w is None else jnp.asarray(w, F),
                             interpret=True)
    for name in ("psi0", "psi1_y", "psi2", "yy", "kl", "n"):
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=VALUE_RTOL, err_msg=name)


@pytest.mark.parametrize("n,q,m", CASES, ids=IDS)
def test_backward_parity(n, q, m):
    """Gradients of a probe of the statistics with respect to mu, s, Z,
    sf2, alpha and y through the custom VJP match jax.grad of the XLA
    engine."""
    y, mu, s, z, sf2, alpha, w = _problem(n, q, m, seed=1)
    pr = np.random.default_rng(2)
    wy = pr.standard_normal((m, 3))
    wp = pr.standard_normal((m, m))

    def obj(stats_fn, w):
        def f(mu, s, z, sf2, alpha, y):
            st = stats_fn(y, mu, s, z, sf2, alpha, weights=w)
            return jnp.sum(st.psi1_y * wy) + jnp.sum(st.psi2 * wp) + st.kl
        return jax.grad(f, argnums=(0, 1, 2, 3, 4, 5))

    g_ref = obj(psi.suff_stats, w)(mu, s, z, sf2, alpha, y)
    g_gpu = jax.jit(obj(
        lambda *a, weights: psi_gpu.suff_stats(*a, weights=weights,
                                               interpret=True),
        jnp.asarray(w, F)))(*_f32(mu, s, z, sf2, alpha, y))
    for name, a, b in zip(["mu", "s", "z", "sf2", "alpha", "y"], g_gpu, g_ref):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b,
                                   atol=GRAD_ATOL * np.abs(b).max(),
                                   err_msg=name)


def test_weight_gradient():
    """d/dw of sum_n w_n Psi2_n is Psi2_n itself: the kernel's dw output."""
    y, mu, s, z, sf2, alpha, w = _problem(40, 2, 6, seed=3)
    probe = np.random.default_rng(4).standard_normal((6, 6))

    def f(engine):
        return jax.grad(lambda ww: jnp.sum(engine(ww) * probe))

    g_ref = f(lambda ww: psi.psi2_sum(mu, s, z, sf2, alpha, ww))(w)
    g_gpu = f(lambda ww: psi_gpu.psi2_sum(*_f32(mu, s, z, sf2, alpha), ww,
                                          interpret=True))(jnp.asarray(w, F))
    np.testing.assert_allclose(np.asarray(g_gpu), g_ref,
                               atol=GRAD_ATOL * np.abs(g_ref).max())


def test_features_reproduce_psi2_exponent():
    """The identity the kernels rest on: F @ G is log Psi2_n for every
    upper-triangle pair (exact in float64)."""
    y, mu, s, z, sf2, alpha, w = _problem(9, 3, 4)
    with jax.enable_x64(True):
        k = psi_gpu.feature_width(3)
        den = 2.0 * alpha * s + 1.0
        c = alpha / den
        const = (2 * np.log(sf2) - 0.5 * np.log(den).sum(1)
                 - (c * mu * mu).sum(1))
        f = np.concatenate([np.ones((9, 1)), const[:, None], c * mu, c,
                            np.zeros((9, k - 8))], axis=1)
        iu, ju = np.triu_indices(4)
        zb = 0.5 * (z[iu] + z[ju])
        e0 = -0.25 * (alpha * (z[iu] - z[ju]) ** 2).sum(1)
        g = np.concatenate([e0[:, None], np.ones((10, 1)), 2 * zb, -zb * zb,
                            np.zeros((10, k - 8))], axis=1).T
        log_e0, const_n, v, cc = psi._psi2_pieces(mu, s, z, sf2, alpha)
        b = np.einsum("nq,mq,pq->nmp", cc, z, z)
        want = (const_n[:, None, None] + v[:, :, None] + v[:, None, :]
                - 0.5 * b + log_e0[None])[:, iu, ju]
        np.testing.assert_allclose(f @ g, want, rtol=1e-12, atol=1e-12)
        assert psi_gpu.row_features(mu, s, sf2, alpha, k).shape == (9, k)
        assert psi_gpu.pair_features(z, alpha, k).shape == (k, 10)


@pytest.mark.parametrize("n,m,want", [
    (24, 5, (1, 64, 64)),               # one pair tile, one row split
    (10_000, 200, (4, 10_240, 20_160)),  # 315 pair tiles -> 4 splits
    (10**6, 500, (1, 1_000_000, 125_312)),
])
def test_grid_split(n, m, want):
    """Row splits bring the forward/dG grids near _PROGRAMS programs; N pads
    to 64 rows x splits and the pair count to the 64-pair tile."""
    assert psi_gpu.grid_split(n, m) == want


def test_feature_width():
    assert [psi_gpu.feature_width(q) for q in (1, 7, 8, 10, 15, 16)] == [
        16, 16, 32, 32, 32, 64]


def test_kernel_inside_shard_map():
    """The kernels under shard_map on the 8 virtual devices, psum'd over
    the mesh, match the XLA statistics of the whole dataset — values and
    gradients. The interpreter inlines the kernel body into the shard_map
    trace, where its loop carries mix device-varying and unvarying values,
    so the varying-manual-axes checker is off here; the compiled kernel is
    opaque to it and runs with the checker on (parallel/stats.py)."""
    from gparml.parallel import mesh as mesh_lib

    y, mu, s, z, sf2, alpha, w = _problem(40, 2, 5, seed=5)
    mesh = mesh_lib.make_mesh(8)
    ys, mus, ss, ws = mesh_lib.shard_data(mesh, *[np.asarray(a, np.float32)
                                                  for a in (y, mu, s)])

    def sharded(mu_, s_, z_):
        def local(y, mu, s, w, z):
            st = psi_gpu.suff_stats(y, mu, s, z, F(sf2), jnp.asarray(alpha, F),
                                    weights=w, vary_axis="data",
                                    interpret=True)
            return jax.tree.map(lambda t: jax.lax.psum(t, "data"), st)
        st = jax.shard_map(local, mesh=mesh,
                           in_specs=(P("data"),) * 4 + (P(),),
                           out_specs=P(), check_vma=False)(ys, mu_, s_, ws, z_)
        return jnp.sum(st.psi2) + jnp.sum(st.psi1_y), st

    (v, st), g = jax.jit(jax.value_and_grad(sharded, argnums=(0, 1, 2),
                                            has_aux=True))(mus, ss,
                                                           jnp.asarray(z, F))

    def whole(mu_, s_, z_):
        st = psi.suff_stats(y, mu_, s_, z_, sf2, alpha)
        return jnp.sum(st.psi2) + jnp.sum(st.psi1_y)

    v_ref, g_ref = jax.value_and_grad(whole, argnums=(0, 1, 2))(mu, s, z)
    np.testing.assert_allclose(float(v), float(v_ref), rtol=VALUE_RTOL)
    for a, b in zip(g, g_ref):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a)[:b.shape[0]], b,
                                   atol=GRAD_ATOL * np.abs(b).max())


@pytest.mark.gpu
def test_compiled_kernels_match_xla_on_gpu(gpu_device):
    """The kernels as compiled for the card against the XLA engine run on
    the card in float64, at a ragged N and an M off the tile."""
    y, mu, s, z, sf2, alpha, w = _problem(5000, 10, 77, seed=6)
    ref = psi.suff_stats(y, mu, s, z, sf2, alpha)
    got = jax.jit(psi_gpu.suff_stats)(*_f32(y, mu, s, z, sf2, alpha))
    np.testing.assert_allclose(np.asarray(got.psi2), np.asarray(ref.psi2),
                               rtol=2e-4)
