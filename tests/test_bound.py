"""Bound parity (B-form vs oracle's A-form), dense-GP limit, and gradient
checks via finite differences (SURVEY.md §4 items 1-2)."""


import numpy as np
import jax
import jax.numpy as jnp
from jax.test_util import check_grads

from gparml.ops import bound, psi
from tests import oracle
from tests.conftest import make_problem

RTOL = 1e-8


def _stats(y, mu, s, z, sf2, alpha):
    return psi.suff_stats(
        jnp.asarray(y), jnp.asarray(mu),
        None if s is None else jnp.asarray(s),
        jnp.asarray(z), sf2, jnp.asarray(alpha),
    )


def test_gplvm_bound_matches_oracle(rng):
    y, mu, s, z, sf2, alpha, beta = make_problem(rng)
    st = _stats(y, mu, s, z, sf2, alpha)
    got = bound.bound_from_stats(st, jnp.asarray(z), sf2, jnp.asarray(alpha), beta, d=y.shape[1])
    want = oracle.bound(y, mu, s, z, sf2, alpha, beta)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_sgpr_bound_matches_oracle(rng):
    y, x, s, z, sf2, alpha, beta = make_problem(rng, latent=False)
    st = _stats(y, x, None, z, sf2, alpha)
    got = bound.bound_from_stats(st, jnp.asarray(z), sf2, jnp.asarray(alpha), beta, d=y.shape[1])
    want = oracle.bound(y, x, None, z, sf2, alpha, beta)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_dense_gp_limit(rng):
    """Z = X, s -> 0 (and no KL): the collapsed bound reproduces the exact
    dense-GP marginal log-likelihood (Titsias bound is tight at Z=X)."""
    n, d, q = 10, 2, 2
    x = rng.standard_normal((n, q))
    y = rng.standard_normal((n, d))
    sf2, beta = 1.7, 3.0
    alpha = rng.uniform(0.5, 1.5, size=(q,))
    st = _stats(y, x, None, x, sf2, alpha)
    got = bound.bound_from_stats(
        st, jnp.asarray(x), sf2, jnp.asarray(alpha), beta, d=d, jitter=1e-10
    )
    want = oracle.dense_gp_loglik(y, x, sf2, alpha, beta)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_bound_upper_bounded_by_dense_gp(rng):
    """For fixed hypers, the sparse bound with M < N inducing points must lie
    below the dense marginal likelihood."""
    n, d, q, m = 12, 2, 2, 4
    x = rng.standard_normal((n, q))
    y = rng.standard_normal((n, d))
    z = rng.standard_normal((m, q))
    sf2, beta = 1.1, 2.0
    alpha = np.ones(q)
    st = _stats(y, x, None, z, sf2, alpha)
    f = bound.bound_from_stats(st, jnp.asarray(z), sf2, jnp.asarray(alpha), beta, d=d)
    ll = oracle.dense_gp_loglik(y, x, sf2, alpha, beta)
    assert float(f) < ll


def test_gradients_vs_finite_differences(rng):
    """jax.grad of the full objective vs numerical differentiation — replaces
    the reference's hand-coded-derivative FD scripts (SURVEY.md §4 item 1)."""
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=8, d=2, q=2, m=4)
    yj = jnp.asarray(y)

    def f(muj, sj, zj, sf2j, alphaj, betaj):
        st = psi.suff_stats(yj, muj, sj, zj, sf2j, alphaj)
        return bound.bound_from_stats(st, zj, sf2j, alphaj, betaj, d=y.shape[1])

    args = (
        jnp.asarray(mu), jnp.asarray(s), jnp.asarray(z),
        jnp.asarray(sf2), jnp.asarray(alpha), jnp.asarray(beta),
    )
    check_grads(f, args, order=1, modes=["rev"], atol=1e-5, rtol=1e-5)


def test_predict_recovers_function(rng):
    """SGPR prediction on noiseless-ish data interpolates the training data."""
    n, m = 40, 20
    x = np.linspace(-3, 3, n)[:, None]
    y = np.sin(x)
    z = np.linspace(-3, 3, m)[:, None]
    sf2, beta = 1.0, 1e4
    alpha = np.array([1.0])
    st = _stats(y, x, None, z, sf2, alpha)
    mean, var = bound.predict(jnp.asarray(x), st, jnp.asarray(z), sf2, jnp.asarray(alpha), beta)
    np.testing.assert_allclose(mean, y, atol=2e-2)
    assert np.all(np.asarray(var) > 0)


def test_predict_uncertain_matches_monte_carlo(rng):
    """bound.predict_uncertain (GPLVM reconstruction through Psi1
    expectations) vs Monte-Carlo integration of bound.predict over q(x*)."""
    from gparml.ops import bound, psi

    n, d, q, m = 60, 2, 2, 12
    x = rng.standard_normal((n, q))
    y = np.tanh(x @ rng.standard_normal((q, d)))
    z = rng.standard_normal((m, q))
    sf2, beta = 1.0, 50.0
    alpha = np.ones(q)
    st = psi.suff_stats(jnp.asarray(y), jnp.asarray(x), None, jnp.asarray(z), sf2, jnp.asarray(alpha))

    mu_star = rng.standard_normal((3, q))
    s_star = np.full((3, q), 0.3)
    mean_u, var_u = bound.predict_uncertain(
        jnp.asarray(mu_star), jnp.asarray(s_star), st, jnp.asarray(z), sf2, jnp.asarray(alpha), beta
    )

    # Monte Carlo: sample x* ~ q, average the certain-input predictive mean
    k = 4000
    eps = rng.standard_normal((k, 3, q))
    xs = (mu_star[None] + np.sqrt(s_star)[None] * eps).reshape(k * 3, q)
    mc_mean, _ = bound.predict(jnp.asarray(xs), st, jnp.asarray(z), sf2, jnp.asarray(alpha), beta)
    mc_mean = np.asarray(mc_mean).reshape(k, 3, d).mean(0)
    np.testing.assert_allclose(np.asarray(mean_u), mc_mean, atol=0.02)
    assert np.all(np.asarray(var_u) > 1.0 / beta - 1e-9)


def test_predict_uncertain_blocked_matches_per_point_solves(rng):
    """The O(block*M^2) scan path (Frobenius contraction against precomputed
    K_MM^-1 / A^-1) must match (a) itself at block >= N* and (b) an
    independent per-point triangular-solve oracle, including at an N* that is
    NOT a multiple of the block (padding discarded)."""
    from jax.scipy.linalg import solve_triangular

    from gparml.ops import bound, psi

    n, d, q, m = 80, 2, 2, 12
    x = rng.standard_normal((n, q))
    y = np.tanh(x @ rng.standard_normal((q, d)))
    z = rng.standard_normal((m, q))
    sf2, beta = 1.0, 50.0
    alpha = jnp.ones(q)
    st = psi.suff_stats(jnp.asarray(y), jnp.asarray(x), None, jnp.asarray(z),
                        sf2, alpha)

    n_star = 23  # prime: exercises the padding remainder at block=8
    mu_star = jnp.asarray(rng.standard_normal((n_star, q)))
    s_star = jnp.asarray(0.1 + 0.4 * rng.random((n_star, q)))
    zj = jnp.asarray(z)

    mean_b, var_b = bound.predict_uncertain(
        mu_star, s_star, st, zj, sf2, alpha, beta, block=8)
    mean_1, var_1 = bound.predict_uncertain(
        mu_star, s_star, st, zj, sf2, alpha, beta, block=4096)
    np.testing.assert_allclose(np.asarray(mean_b), np.asarray(mean_1),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(var_b), np.asarray(var_1),
                               rtol=1e-5)

    # degenerate inputs (review r5): empty N* returns empty cleanly, and a
    # nonsensical block <= 0 clamps instead of ZeroDivisionError
    m_e, v_e = bound.predict_uncertain(
        jnp.zeros((0, q)), jnp.ones((0, q)), st, zj, sf2, alpha, beta)
    assert m_e.shape == (0, d) and v_e.shape == (0,)
    m_0, v_0 = bound.predict_uncertain(
        mu_star, s_star, st, zj, sf2, alpha, beta, block=0)
    np.testing.assert_allclose(np.asarray(m_0), np.asarray(mean_1), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(v_0), np.asarray(var_1), rtol=1e-5)

    # independent oracle: per-point (M, M) psi2 + triangular solves
    lm, lb, _ = bound.posterior(st, zj, sf2, alpha, beta)

    def per_point(mu_n, s_n):
        p2n = psi.psi2_sum(mu_n[None], s_n[None], zj, sf2, alpha)
        c2 = solve_triangular(
            lm, solve_triangular(lm, p2n, lower=True).T, lower=True)
        t2 = solve_triangular(lb, solve_triangular(lm, p2n, lower=True),
                              lower=True)
        c3 = solve_triangular(lb, solve_triangular(lm, t2.T, lower=True),
                              lower=True)
        return jnp.trace(c2), jnp.trace(c3)

    tr_k, tr_a = jax.vmap(per_point)(mu_star, s_star)
    var_oracle = jnp.maximum(sf2 - tr_k + tr_a, 0.0) + 1.0 / beta
    np.testing.assert_allclose(np.asarray(var_b), np.asarray(var_oracle),
                               rtol=2e-4)


def test_bound_invariant_to_inducing_permutation(rng):
    """Permuting the rows of Z must leave the bound exactly invariant (the
    math only sees the set of inducing points)."""
    y, mu, s, z, sf2, alpha, beta = make_problem(rng)
    perm = rng.permutation(z.shape[0])

    def f(zz):
        st = psi.suff_stats(
            jnp.asarray(y), jnp.asarray(mu), jnp.asarray(s), zz, sf2, jnp.asarray(alpha)
        )
        return bound.bound_from_stats(st, zz, sf2, jnp.asarray(alpha), beta, d=y.shape[1])

    np.testing.assert_allclose(
        float(f(jnp.asarray(z))), float(f(jnp.asarray(z[perm]))), rtol=1e-10
    )


def test_f32_bound_bounded_under_ill_conditioning(rng):
    """float32 anti-runaway clamps (bound.py): at near-singular K_MM the f32
    solves can overshoot the exact inequalities tr(K_MM^-1 Psi2) <= psi0 and
    beta^2 quad <= beta yy, handing an optimizer an unbounded artifact to
    climb (observed: beta -> 2e4, sf2 -> 1e3 on a vanilla 1-D SGPR fit). The
    clamped f32 bound must stay within noise of the float64 truth even at
    the pathological hypers that previously blew it up."""
    n, d, q, m = 400, 1, 1, 12
    x = np.sort(rng.uniform(-3, 3, (n, q)), axis=0)
    y = np.sin(1.5 * x) + 0.2 * rng.standard_normal((n, d))
    z = np.linspace(-3, 3, m)[:, None]
    # long lengthscale + large sf2/beta: K_MM nearly rank-1 in f32
    sf2, alpha, beta = 975.0, np.array([0.0188]), 22539.0

    def f(dt):
        st = psi.suff_stats(
            jnp.asarray(y, dt), jnp.asarray(x, dt), None, jnp.asarray(z, dt),
            jnp.asarray(sf2, dt), jnp.asarray(alpha, dt),
        )
        return float(bound.bound_from_stats(
            st, jnp.asarray(z, dt), jnp.asarray(sf2, dt), jnp.asarray(alpha, dt),
            jnp.asarray(beta, dt), d=d,
        ))

    f32 = f(jnp.float32)
    # Pre-clamp this overshot to ~+5e9 (and the optimizer climbed it); the
    # true bound at these hypers is hugely negative (the f64 path itself
    # NaNs at condition ~1e17, so finite-and-negative is the assertable
    # contract). A lower bound guards against the clamps overshooting the
    # other way.
    assert np.isfinite(f32) and -1e9 < f32 < 0.0, f32


def test_f32_bound_finite_at_large_m(rng):
    """Regression (round 3): the f32 PSD-by-construction path's Psi2 jitter
    must scale with the spectrum TOP (trace), not the mean — with the old
    1e-6*tr/M jitter every f32 GPLVM bound at M >= 200 was NaN (observed
    cond(Psi2+eps) ~ 3.5e8, f32 Cholesky breakdown)."""
    import jax
    from gparml import data
    from gparml.models import gplvm

    y, _ = data.synthetic_gplvm(n=3000, d=6, q_true=2, seed=9)
    # m=200 is where the f32 breakdown appeared
    for m in (200,):
        cfg = gplvm.GPLVMConfig(q=3, num_inducing=m, stats_impl="xla")
        p0 = gplvm.init_params(
            jax.random.key(0), jnp.asarray(y, jnp.float32), cfg
        )
        f, g = jax.jit(
            lambda p, yy: gplvm.neg_bound_value_and_grad(p, yy, cfg)
        )(p0, jnp.asarray(y, jnp.float32))
        assert np.isfinite(float(f)), m
        assert all(np.all(np.isfinite(l)) for l in jax.tree.leaves(g)), m


def test_f32_chol_psi2_fallback_has_finite_gradients(rng):
    """Regression: when the first jitter rung's Cholesky NaNs,
    the old two-cholesky + jnp.where select kept the NaN primal in the
    autodiff graph — forward finite, gradients all-NaN (a NaN-primal
    Cholesky VJP poisons the cotangent even when where() discards it).
    The probe must be nondifferentiable and only the jitter scalar selected.

    Constructs a float32 psi2 whose most negative eigenvalue exceeds the
    first rung (30*eps*tr) but not the fallback (3000*eps*tr)."""
    m = 24
    a = rng.standard_normal((m, m))
    base = (a @ a.T).astype(np.float32)
    w, v = np.linalg.eigh(base.astype(np.float64))
    tr = float(np.sum(w))
    eps = float(np.finfo(np.float32).eps)
    # min eig ~ -100*eps*tr: past rung 1 (30), well inside rung 2 (3000)
    w[0] = -100.0 * eps * tr
    psi2_np = (v @ np.diag(w) @ v.T).astype(np.float32)

    # rung-1 probe really does NaN on this input
    probe = jnp.linalg.cholesky(
        jnp.asarray(psi2_np) + np.float32(30.0 * eps * tr) * jnp.eye(m, dtype=jnp.float32)
    )
    assert not bool(jnp.all(jnp.isfinite(probe))), "test fixture too easy"

    def f(p2):
        return jnp.sum(bound._chol_psi2(p2)) * 1e-3

    val, g = jax.value_and_grad(f)(jnp.asarray(psi2_np))
    assert np.isfinite(float(val))
    assert np.all(np.isfinite(np.asarray(g))), "fallback gradients are NaN"
