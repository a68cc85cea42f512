"""SCG optimizer unit tests: quadratic/Rosenbrock convergence, monotone
accepted-step history, pytree parameters (SURVEY.md §4 item 4)."""

import numpy as np
import jax
import jax.numpy as jnp

from gparml.opt import scg


def test_quadratic_exact_convergence():
    """On a convex quadratic, CG-type methods converge in ~dim steps."""
    a = jnp.asarray(np.diag([1.0, 4.0, 9.0, 0.5]))
    b = jnp.asarray(np.array([1.0, -2.0, 3.0, 0.2]))

    def vg(x):
        f = 0.5 * x @ a @ x - b @ x
        return f, a @ x - b

    x0 = jnp.zeros(4)
    st = jax.jit(lambda x: scg.minimize(vg, x, scg.SCGOptions(max_iters=50)))(x0)
    x_star = np.linalg.solve(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(st.x, x_star, atol=1e-4)
    assert bool(st.done) and int(st.iteration) < 30


def test_rosenbrock():
    def rosen(x):
        return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)

    vg = jax.value_and_grad(rosen)
    x0 = jnp.asarray(np.array([-1.2, 1.0]))
    st = jax.jit(lambda x: scg.minimize(vg, x, scg.SCGOptions(max_iters=400)))(x0)
    np.testing.assert_allclose(st.x, np.ones(2), atol=1e-4)


def test_pytree_params_and_monotone_history():
    """Params as a nested pytree; accepted objective values never increase."""
    def vg(p):
        f = jnp.sum((p["w"] - 3.0) ** 2) + jnp.sum((p["b"]["c"] + 1.0) ** 4)
        return f, jax.grad(lambda q: jnp.sum((q["w"] - 3.0) ** 2) + jnp.sum((q["b"]["c"] + 1.0) ** 4))(p)

    p0 = {"w": jnp.zeros((3, 2)), "b": {"c": jnp.ones(5)}}
    st = jax.jit(lambda p: scg.minimize(vg, p, scg.SCGOptions(max_iters=100)))(p0)
    np.testing.assert_allclose(st.x["w"], 3.0, atol=1e-5)
    np.testing.assert_allclose(st.x["b"]["c"], -1.0, atol=1e-2)
    hist = np.asarray(st.history.f)
    valid = np.isfinite(hist)
    # f_now history is non-increasing (rejected steps keep the old value)
    assert np.all(np.diff(hist[valid]) <= 1e-12)
    # the trace struct is populated consistently on executed iterations
    assert np.all(np.isfinite(np.asarray(st.history.gnorm2)[valid]))
    assert np.all(np.asarray(st.history.lam)[valid] > 0)
    assert np.all(np.isfinite(np.asarray(st.history.alpha)[valid]))
    assert np.asarray(st.history.accepted)[valid].any()


def test_bucket_iters():
    assert scg.bucket_iters(0) == 0
    assert scg.bucket_iters(1) == 128
    assert scg.bucket_iters(100) == 128
    assert scg.bucket_iters(128) == 128
    assert scg.bucket_iters(129) == 256
    assert scg.bucket_iters(1000) == 1024


def test_dynamic_iter_limit_matches_static():
    """minimize with a bucketed history + traced iter_limit must run the
    EXACT same trajectory as the static max_iters program, stopping at the
    same iteration — the limit only moves from a compile-time constant to a
    runtime scalar (one shared program across different -T budgets)."""
    a = jnp.asarray(np.diag([1.0, 4.0, 9.0, 0.5]))
    b = jnp.asarray(np.array([1.0, -2.0, 3.0, 0.2]))

    def vg(x):
        f = 0.5 * x @ a @ x - b @ x
        return f, a @ x - b

    x0 = jnp.full(4, 0.3)
    for t in (3, 17):
        static = jax.jit(
            lambda x: scg.minimize(vg, x, scg.SCGOptions(max_iters=t))
        )(x0)
        opts = scg.SCGOptions(max_iters=scg.bucket_iters(t))
        dyn = jax.jit(
            lambda x, il: scg.minimize(vg, x, opts, iter_limit=il)
        )(x0, jnp.int32(t))
        assert int(dyn.iteration) == int(static.iteration)
        np.testing.assert_array_equal(np.asarray(dyn.x), np.asarray(static.x))
        k = int(static.iteration)
        np.testing.assert_array_equal(
            np.asarray(dyn.history.f)[:k], np.asarray(static.history.f)[:k])
        # padding beyond the executed iterations stays nan (dropped by
        # utils.logging.write_history)
        assert np.all(np.isnan(np.asarray(dyn.history.f)[k:]))

    # the clamp: a limit above the history capacity cannot overrun it
    opts8 = scg.SCGOptions(max_iters=8)
    over = jax.jit(
        lambda x, il: scg.minimize(vg, x, opts8, iter_limit=il)
    )(x0, jnp.int32(50))
    assert int(over.iteration) <= 8


def test_fit_shares_program_across_iteration_budgets():
    """gplvm.fit traces to the same jaxpr shapes for different `iters` below
    one bucket: the history capacity is bucketed and the budget rides as a
    runtime scalar, so a resume with a new -T hits the persistent compile
    cache instead of recompiling the fused fit."""
    from gparml.models import gplvm

    rng = np.random.default_rng(0)
    y = jnp.asarray(rng.standard_normal((40, 4)), jnp.float32)
    cfg = gplvm.GPLVMConfig(q=2, num_inducing=6)
    p0 = gplvm.init_params(jax.random.key(0), y, cfg)
    r20 = gplvm.fit(p0, y, cfg, iters=20)
    r50 = gplvm.fit(p0, y, cfg, iters=50)
    # same bucket -> same history capacity; trajectories agree on the
    # shared prefix (identical algorithm, identical program)
    assert r20.history.shape == r50.history.shape == (128,)
    h20, h50 = np.asarray(r20.history), np.asarray(r50.history)
    k = min(int(np.isfinite(h20).sum()), int(np.isfinite(h50).sum()), 20)
    np.testing.assert_array_equal(h20[:k], h50[:k])


def test_stepped_matches_fused_quadratic():
    """minimize_stepped executes the identical algorithm (shared body):
    bit-level trajectory parity with the fused while_loop driver."""
    a = jnp.asarray(np.diag([1.0, 4.0, 9.0, 0.5]))
    b = jnp.asarray(np.array([1.0, -2.0, 3.0, 0.2]))

    def vg(x, a, b):
        f = 0.5 * x @ a @ x - b @ x
        return f, a @ x - b

    x0 = jnp.zeros(4)
    opts = scg.SCGOptions(max_iters=50)
    fused = jax.jit(lambda x: scg.minimize(lambda p: vg(p, a, b), x, opts))(x0)
    stepped = scg.minimize_stepped(vg, x0, opts, extra=(a, b))
    # Same algorithm, but different program partitionings are not bit-equal:
    # near convergence an ulp flips the stop iteration. Compare the early
    # trajectory tightly and both optima against the analytic solution.
    k = min(int(fused.iteration), int(stepped.iteration), 10)
    np.testing.assert_allclose(
        np.asarray(fused.history.f)[:k], np.asarray(stepped.history.f)[:k],
        rtol=1e-9)
    x_star = np.linalg.solve(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(np.asarray(stepped.x), x_star, atol=1e-4)
    np.testing.assert_allclose(np.asarray(fused.x), x_star, atol=1e-4)
    # host loop honored the convergence flag (did not run to max_iters)
    assert bool(stepped.done) and int(stepped.iteration) < opts.max_iters
    # the caller's x0 buffer survives the donation scheme
    np.testing.assert_array_equal(np.asarray(x0), 0.0)


def test_stepped_pytree_params():
    def vg(p):
        obj = lambda q: jnp.sum((q["w"] - 3.0) ** 2) + jnp.sum((q["b"]["c"] + 1.0) ** 4)
        return obj(p), jax.grad(obj)(p)

    p0 = {"w": jnp.zeros((3, 2)), "b": {"c": jnp.ones(5)}}
    st = scg.minimize_stepped(vg, p0, scg.SCGOptions(max_iters=100))
    np.testing.assert_allclose(st.x["w"], 3.0, atol=1e-5)
    np.testing.assert_allclose(st.x["b"]["c"], -1.0, atol=1e-2)


def test_use_stepped_resolution():
    assert scg.use_stepped("stepped", 1)
    assert not scg.use_stepped("fused", 10**9)
    assert scg.use_stepped("auto", scg.STEPPED_N_THRESHOLD)
    assert not scg.use_stepped("auto", scg.STEPPED_N_THRESHOLD - 1)
    try:
        scg.use_stepped("bogus", 1)
    except ValueError:
        pass
    else:
        raise AssertionError("bad mode must raise")


def test_early_convergence_stops_evals():
    """Once converged, the loop exits (history stays nan afterwards)."""
    def vg(x):
        f = jnp.sum(x**2)
        return f, 2.0 * x

    st = jax.jit(lambda x: scg.minimize(vg, x, scg.SCGOptions(max_iters=500)))(
        jnp.ones(3)
    )
    hist = np.asarray(st.history.f)
    assert np.isnan(hist[-1])  # converged long before 500 iterations
    assert float(st.f_now) < 1e-12
