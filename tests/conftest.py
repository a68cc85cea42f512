"""Test configuration: force an 8-virtual-device CPU backend (SURVEY.md §4:
"the fake backend that makes distributed tests run anywhere") and enable x64
so parity gates run at 1e-6 rtol against the float64 oracle.

Tests marked ``gpu`` need an NVIDIA GPU; the ``gpu_device`` fixture skips
them elsewhere (decided when the test runs, never at import, so every
xdist worker collects the same tests). The backend is the CPU unless
JAX_PLATFORMS names another; on the card the GPU tests run with
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu -p no:xdist``."""

import os

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
# A persistent cache makes test re-runs fast.
from gparml.utils import compile_cache  # noqa: E402

compile_cache.enable()
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when the backend has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (backend is "
                    f"{jax.default_backend()!r})")
    return jax.devices()[0]


def make_problem(rng, n=12, d=3, q=2, m=5, latent=True):
    """Small random GPLVM/SGPR problem in float64."""
    y = rng.standard_normal((n, d))
    mu = rng.standard_normal((n, q))
    s = rng.uniform(0.2, 1.5, size=(n, q)) if latent else None
    z = rng.standard_normal((m, q))
    sf2 = 1.3
    alpha = rng.uniform(0.3, 2.0, size=(q,))
    beta = 2.1
    return y, mu, s, z, sf2, alpha, beta
