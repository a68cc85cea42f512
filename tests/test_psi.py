"""Psi-statistics parity vs the float64 oracle + structural identities.

Covers the reference's most important validation idea (SURVEY.md §4 item 1-2):
closed forms checked against an independent implementation, plus the s->0
limits Psi1 -> K_NM, Psi2 -> K_NM^T K_NM."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gparml.ops import ard_rbf, psi
from tests import oracle
from tests.conftest import make_problem

RTOL = 1e-9


def test_kernel_matches_oracle(rng):
    y, mu, s, z, sf2, alpha, beta = make_problem(rng)
    got = ard_rbf.k(jnp.asarray(mu), jnp.asarray(z), sf2, jnp.asarray(alpha))
    want = oracle.kern(mu, z, sf2, alpha)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_psi1_matches_oracle(rng):
    y, mu, s, z, sf2, alpha, beta = make_problem(rng)
    got = psi.psi1(jnp.asarray(mu), jnp.asarray(s), jnp.asarray(z), sf2, jnp.asarray(alpha))
    want = oracle.psi1(mu, s, z, sf2, alpha)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_psi2_matches_oracle(rng):
    y, mu, s, z, sf2, alpha, beta = make_problem(rng)
    got = psi.psi2_sum(jnp.asarray(mu), jnp.asarray(s), jnp.asarray(z), sf2, jnp.asarray(alpha))
    want = oracle.psi2(mu, s, z, sf2, alpha).sum(axis=0)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_kl_matches_oracle(rng):
    y, mu, s, z, sf2, alpha, beta = make_problem(rng)
    got = psi.kl_qp(jnp.asarray(mu), jnp.asarray(s))
    np.testing.assert_allclose(got, oracle.kl(mu, s), rtol=RTOL)


def test_s_to_zero_limits(rng):
    y, mu, s, z, sf2, alpha, beta = make_problem(rng)
    s0 = np.full_like(mu, 1e-14)
    knm = ard_rbf.k(jnp.asarray(mu), jnp.asarray(z), sf2, jnp.asarray(alpha))
    p1 = psi.psi1(jnp.asarray(mu), jnp.asarray(s0), jnp.asarray(z), sf2, jnp.asarray(alpha))
    np.testing.assert_allclose(p1, knm, rtol=1e-7)
    p2 = psi.psi2_sum(jnp.asarray(mu), jnp.asarray(s0), jnp.asarray(z), sf2, jnp.asarray(alpha))
    np.testing.assert_allclose(p2, knm.T @ knm, rtol=1e-7)


def test_suff_stats_sgpr_mode(rng):
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, latent=False)
    st = psi.suff_stats(
        jnp.asarray(y), jnp.asarray(mu), None, jnp.asarray(z), sf2, jnp.asarray(alpha)
    )
    knm = oracle.kern(mu, z, sf2, alpha)
    np.testing.assert_allclose(st.psi1_y, knm.T @ y, rtol=RTOL)
    np.testing.assert_allclose(st.psi2, knm.T @ knm, rtol=RTOL)
    np.testing.assert_allclose(st.psi0, mu.shape[0] * sf2, rtol=RTOL)
    np.testing.assert_allclose(st.yy, np.sum(y**2), rtol=RTOL)
    assert st.kl == 0.0


def test_blocked_suff_stats_match_dense(rng):
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=24)
    args = (jnp.asarray(y), jnp.asarray(mu), jnp.asarray(s), jnp.asarray(z), sf2, jnp.asarray(alpha))
    dense = psi.suff_stats(*args)
    blocked = psi.suff_stats(*args, block=4)
    for a, b in zip(dense, blocked):
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_partition_invariance_of_stats(rng):
    """Sufficient statistics are an exact sum decomposition over any split of N
    (SURVEY.md §4 item 3 — the reference's key implicit integration test)."""
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=16)
    whole = psi.suff_stats(
        jnp.asarray(y), jnp.asarray(mu), jnp.asarray(s), jnp.asarray(z), sf2, jnp.asarray(alpha)
    )
    parts = None
    for sl in [slice(0, 5), slice(5, 6), slice(6, 16)]:
        st = psi.suff_stats(
            jnp.asarray(y[sl]), jnp.asarray(mu[sl]), jnp.asarray(s[sl]),
            jnp.asarray(z), sf2, jnp.asarray(alpha),
        )
        parts = st if parts is None else parts + st
    for a, b in zip(whole, parts):
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_derive_block_bounds_the_slab():
    """The derived block keeps one scan step's slab within SLAB_BYTES, is a
    multiple of 8, splits N into equal blocks, and is N when all rows fit."""
    assert psi.derive_block(1000, 200, 4) == 1000
    # BASELINE config 4 (N=1e6, M=200, float32): 160 kB per row
    b = psi.derive_block(1_000_000, 200, 4)
    assert b % 8 == 0 and b * 200 * 200 * 4 <= psi.SLAB_BYTES + 8 * 160_000
    nb = -(-1_000_000 // b)
    assert nb * b - 1_000_000 < 8 * nb          # padding under 8 rows a block
    # float64 doubles the bytes per row, so the block halves (about)
    assert psi.derive_block(1_000_000, 200, 8) < b
    # SGPR slabs are (block, M): N=1e6 rows at M=200 fit in one step
    assert psi.derive_block(1_000_000, 200, 4, latent=False) == 1_000_000


def _stats_pair(rng, n, latent, block, weights):
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=n, latent=latent)
    w = None if not weights else jnp.asarray(rng.uniform(0.2, 1.0, n))
    args = (jnp.asarray(y), jnp.asarray(mu),
            None if s is None else jnp.asarray(s), jnp.asarray(z), sf2,
            jnp.asarray(alpha))
    return psi.suff_stats(*args, weights=w), psi.suff_stats(
        *args, block=block, weights=w)


@pytest.mark.parametrize("latent", [True, False], ids=["gplvm", "sgpr"])
@pytest.mark.parametrize("weights", [False, True], ids=["unweighted", "weighted"])
def test_last_block_padded_with_weight_zero_rows(rng, latent, weights):
    """A block that does not divide N pads the last block with weight-0 rows
    instead of raising: the statistics equal the unblocked ones."""
    dense, blocked = _stats_pair(rng, 23, latent, 5, weights)
    for a, b in zip(dense, blocked):
        np.testing.assert_allclose(b, a, rtol=1e-12)


@pytest.mark.parametrize("latent", [True, False], ids=["gplvm", "sgpr"])
def test_derived_block_engages_and_matches(rng, latent, monkeypatch):
    """block=None derives a block from N, M and the dtype; with a slab
    bound small enough to force several (padded) blocks, values and
    gradients equal the unblocked statistics."""
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=37, latent=latent)
    monkeypatch.setattr(psi, "SLAB_BYTES", 16 * 5 * (5 if latent else 1) * 8)
    assert psi.derive_block(37, 5, 8, latent) == 16

    def loss(block):
        def f(mu_, z_):
            st = psi.suff_stats(jnp.asarray(y), mu_,
                                None if s is None else jnp.asarray(s), z_,
                                sf2, jnp.asarray(alpha), block=block)
            return jnp.sum(st.psi2) + jnp.sum(st.psi1_y ** 2)
        return jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(mu),
                                                     jnp.asarray(z))

    (v0, g0), (v1, g1) = loss(37), loss(None)
    np.testing.assert_allclose(v1, v0, rtol=1e-12)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


def test_suff_stats_t_pads_ragged_blocks(rng):
    """The transposed scan pads like the row-major one (block 7 of N=20)."""
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=20)
    args = (jnp.asarray(z), sf2, jnp.asarray(alpha))
    ref = psi.suff_stats(jnp.asarray(y), jnp.asarray(mu), jnp.asarray(s), *args)
    got = psi.suff_stats_t(jnp.asarray(y.T), jnp.asarray(mu.T),
                           jnp.asarray(s.T), *args, block=7)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b, a, rtol=1e-12)
