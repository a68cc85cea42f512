"""ARD-RBF (exponentiated quadratic) kernel.

JAX re-design of the reference's kernel module (GParML ``kernels.py``,
see SURVEY.md §2 [C-HIGH]): the reference hand-codes ``K``, ``Kdiag`` and their
derivatives in NumPy; here everything is pure JAX and derivatives come from
autodiff, so only the forward evaluations are needed.

Parameterization (matches SURVEY.md Appendix A):

    k(x, x') = sf2 * exp(-0.5 * sum_q alpha_q * (x_q - x'_q)^2)

where ``alpha_q`` are ARD *precisions* (inverse squared lengthscales) and
``sf2`` is the signal variance.
"""

from __future__ import annotations

import jax.numpy as jnp


def sq_dist(x1: jnp.ndarray, x2: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    """alpha-weighted squared distance matrix.

    Args:
      x1: (N1, Q) inputs.
      x2: (N2, Q) inputs.
      alpha: (Q,) ARD precisions.

    Returns:
      (N1, N2) matrix of sum_q alpha_q (x1[n,q] - x2[m,q])^2.
    """
    # Scale inputs by sqrt(alpha) once, then use the |a-b|^2 = |a|^2 + |b|^2 - 2ab
    # expansion so the inner product is one matrix product.
    ra = jnp.sqrt(alpha)
    a = x1 * ra
    b = x2 * ra
    a2 = jnp.sum(a * a, axis=-1)
    b2 = jnp.sum(b * b, axis=-1)
    ab = jnp.matmul(a, b.T, precision='highest')
    d2 = a2[:, None] + b2[None, :] - 2.0 * ab
    return jnp.maximum(d2, 0.0)


def k(x1: jnp.ndarray, x2: jnp.ndarray, sf2, alpha: jnp.ndarray) -> jnp.ndarray:
    """Kernel matrix K(x1, x2), shape (N1, N2)."""
    return sf2 * jnp.exp(-0.5 * sq_dist(x1, x2, alpha))


def k_diag(x: jnp.ndarray, sf2) -> jnp.ndarray:
    """diag K(x, x) = sf2 * ones(N)."""
    return jnp.full((x.shape[0],), 1.0, dtype=x.dtype) * sf2


def kmm(z: jnp.ndarray, sf2, alpha: jnp.ndarray, jitter: float = 1e-6) -> jnp.ndarray:
    """K(Z, Z) with diagonal jitter, used for the inducing-point Gram matrix.

    The jitter is scaled by sf2 so conditioning is invariant to the signal
    variance (reference adds an absolute jitter; relative is more robust in
    f32), and floored at 100x the dtype epsilon — 1e-6 is fine in float64 but
    underflows the conditioning needs of float32 Cholesky factors.
    """
    import numpy as np

    m = z.shape[0]
    eff = max(float(jitter), 100.0 * float(np.finfo(z.dtype).eps))
    return k(z, z, sf2, alpha) + (eff * sf2) * jnp.eye(m, dtype=z.dtype)
