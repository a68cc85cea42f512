"""Unit tests for support utilities: bijectors, init, mesh helpers, logging,
SCG display — the reference's supporting_functions.py surface (SURVEY.md §2)."""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gparml.parallel import mesh as mesh_lib
from gparml.utils import init as init_utils
from gparml.utils import logging as glog
from gparml.utils import transforms


@pytest.mark.parametrize("name", ["exp", "softplus"])
def test_bijector_roundtrip(name, rng):
    bij = transforms.get(name)
    y = jnp.asarray(rng.uniform(0.01, 100.0, 64))
    np.testing.assert_allclose(bij.forward(bij.inverse(y)), y, rtol=1e-10)
    x = jnp.asarray(rng.standard_normal(64))
    assert np.all(np.asarray(bij.forward(x)) > 0)


def test_unknown_bijector_raises():
    with pytest.raises(ValueError):
        transforms.get("nope")


def test_softplus_bijector_end_to_end(rng):
    from gparml.models import sgpr

    x = np.sort(rng.uniform(-2, 2, (80, 1)), axis=0)
    y = np.sin(2 * x) + 0.1 * rng.standard_normal((80, 1))
    cfg = sgpr.SGPRConfig(num_inducing=8, bijector="softplus")
    g0 = sgpr.init_params(jax.random.key(0), jnp.asarray(x), jnp.asarray(y), cfg)
    res = sgpr.fit(g0, jnp.asarray(x), jnp.asarray(y), cfg, iters=40)
    hist = np.asarray(res.history)
    hist = hist[np.isfinite(hist)]
    assert hist[-1] > hist[0]


def test_pca_init_orthogonal_unit_variance(rng):
    y = jnp.asarray(rng.standard_normal((200, 8)) @ np.diag([5, 3, 1, 1, 1, 1, 1, 1]))
    x = init_utils.pca(y, q=2)
    cov = np.cov(np.asarray(x).T)
    np.testing.assert_allclose(cov, np.eye(2), atol=0.15)


def test_fps_inducing_separation(rng):
    """FPS must avoid near-duplicate inducing points on dense sorted data."""
    x = jnp.asarray(np.sort(rng.standard_normal((500, 1)), axis=0))
    z = init_utils.init_inducing(jax.random.key(0), x, 10)
    zs = np.sort(np.asarray(z)[:, 0])
    assert np.min(np.diff(zs)) > 0.05
    z_rand = init_utils.init_inducing(jax.random.key(0), x, 10, method="random")
    assert z_rand.shape == (10, 1)


def test_pad_and_shard_helpers():
    assert mesh_lib.pad_to_multiple(29, 8) == 32
    assert mesh_lib.pad_to_multiple(32, 8) == 32
    m = mesh_lib.make_mesh(2)
    assert m.devices.size == 2
    with pytest.raises(ValueError):
        mesh_lib.make_mesh(10**6)


def test_write_history_jsonl_and_csv(tmp_path):
    hist = np.array([1.0, 2.0, np.nan, 3.0])
    pj = tmp_path / "h.jsonl"
    glog.write_history(str(pj), hist)
    rows = [json.loads(l) for l in open(pj)]
    assert [r["iteration"] for r in rows] == [0, 1, 3]
    pc = tmp_path / "h.csv"
    glog.write_history(str(pc), hist)
    assert open(pc).readline().startswith("iteration")


def test_scg_display_smoke(capfd):
    from gparml.opt import scg

    def vg(x):
        return jnp.sum(x**2), 2.0 * x

    st = jax.jit(
        lambda x: scg.minimize(vg, x, scg.SCGOptions(max_iters=3, display=True))
    )(jnp.ones(3))
    jax.effects_barrier()
    out = capfd.readouterr().out
    assert "SCG iter" in out


def test_distributed_module_surface():
    from gparml.parallel import distributed

    assert distributed.is_coordinator() in (True, False)
    m = distributed.global_mesh()
    assert m.devices.size == len(jax.devices())


def test_iteration_timer_scoped_per_instance():
    """Stamps route to the innermost live timer instance, so
    back-to-back timed fits don't interleave and a nested timer can't
    clobber its parent's stamps."""
    from gparml.utils import logging as glog

    with glog.iteration_timer() as t1:
        glog.stamp_iteration(-1)
        glog.stamp_iteration(0)
        with glog.iteration_timer() as t2:
            glog.stamp_iteration(-1)
            glog.stamp_iteration(0)
            glog.stamp_iteration(1)
        glog.stamp_iteration(1)
    assert [i for i, _ in t1.stamps] == [-1, 0, 1]
    assert [i for i, _ in t2.stamps] == [-1, 0, 1]
    assert set(t1.wall_seconds()) == {0, 1} and set(t2.wall_seconds()) == {0, 1}

    # a second sequential timer starts empty; stamps outside any timer drop
    glog.stamp_iteration(99)
    with glog.iteration_timer() as t3:
        glog.stamp_iteration(-1)
        glog.stamp_iteration(0)
    assert [i for i, _ in t3.stamps] == [-1, 0]
    assert not glog._ACTIVE_TIMERS


def _record_config_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_compile_cache_follows_env_var(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and
    no code sets another."""
    from gparml.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)
    calls = _record_config_updates(monkeypatch)
    assert compile_cache.enable() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls


def test_compile_cache_defaults_to_checkout(monkeypatch):
    """Without the variable the cache is <checkout>/.jax_cache, a fixed
    path computed from the package location."""
    import os

    import gparml
    from gparml.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(gparml.__file__)))
    want = os.path.join(root, ".jax_cache")
    assert compile_cache.cache_dir() == want
    calls = _record_config_updates(monkeypatch)
    compile_cache.enable()
    assert calls["jax_compilation_cache_dir"] == want
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 0.0


@pytest.mark.parametrize("flag,enabled", [("auto", True), ("none", False)])
def test_cli_compile_cache_flag(monkeypatch, flag, enabled):
    """--compile-cache auto turns the shared cache on; none leaves it off.
    There is no directory argument that could override the variable."""
    from gparml import cli
    from gparml.utils import compile_cache

    seen = []
    monkeypatch.setattr(compile_cache, "enable", lambda: seen.append(1))
    opts = cli.build_parser().parse_args(
        ["-i", "in", "-e", "emb", "--compile-cache", flag])
    with pytest.raises(OSError):     # no input folder: stops after the cache
        cli.run(opts)
    assert bool(seen) == enabled
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(
            ["-i", "in", "-e", "emb", "--compile-cache", "/some/dir"])
