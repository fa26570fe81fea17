"""Batched Gaussian primitives.

Batched replacements for the reference's per-point vmapped helpers
(``/root/reference/utils/common_utils.py:50-62``): everything here takes a
batch ``x: [n, d]`` directly and compiles to one matmul against the
(pre-factorized) covariance, instead of vmapping point-wise lambdas.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

# Plain-Python constant: importing this module must never initialize a JAX
# backend (the driver's dryrun_multichip selects the platform *after* import
# machinery starts; a module-level jnp op would lock in the wrong backend).
_LOG_2PI = math.log(2.0 * math.pi)


def chol_factor(cov: jnp.ndarray) -> jnp.ndarray:
    """Lower Cholesky factor of an SPD covariance."""
    return jnp.linalg.cholesky(cov)


def gaussian_sample(key, mean: jnp.ndarray, chol: jnp.ndarray, n: int) -> jnp.ndarray:
    """Sample n points from N(mean, chol @ chol^T).  [n, d].

    Uses the Cholesky factor (the reference uses an SVD square root,
    core/distribution.py:52-66; Cholesky is one triangular matmul).
    """
    d = mean.shape[-1]
    eps = jax.random.normal(key, (n, d), dtype=mean.dtype)
    return eps @ chol.T + mean


def gaussian_logdensity(x: jnp.ndarray, mean: jnp.ndarray, cov: jnp.ndarray) -> jnp.ndarray:
    """log N(x; mean, cov) for x: [..., d] -> [...]."""
    d = mean.shape[-1]
    chol = jnp.linalg.cholesky(cov)
    diff = x - mean  # [..., d]
    # One triangular solve against the whole flattened batch: L y = diff^T.
    y = jax.scipy.linalg.solve_triangular(chol, diff.reshape(-1, d).T, lower=True)
    quad = jnp.sum(y * y, axis=0).reshape(diff.shape[:-1])
    log_det = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
    return -0.5 * (d * _LOG_2PI + log_det + quad)


def gaussian_score(x: jnp.ndarray, mean: jnp.ndarray, cov: jnp.ndarray) -> jnp.ndarray:
    """Score  grad_x log N(x; mean, cov) = cov^{-1} (mean - x),  [..., d]."""
    diff = mean - x
    return jnp.linalg.solve(cov, diff[..., None])[..., 0]


def mixture_logdensity(
    x: jnp.ndarray, means: jnp.ndarray, covs: jnp.ndarray
) -> jnp.ndarray:
    """Uniform-weight Gaussian-mixture log-density.

    x: [..., d]; means: [k, d]; covs: [k, d, d] -> [...].
    (Parity: core/distribution.py:228-257, computed via logsumexp instead of
    exp/mean/log for numerical stability.)
    """
    k = means.shape[0]
    per_comp = jax.vmap(
        lambda m, c: gaussian_logdensity(x, m, c), in_axes=(0, 0), out_axes=-1
    )(means, covs)  # [..., k]
    return jax.scipy.special.logsumexp(per_comp, axis=-1) - jnp.log(k)


def mixture_score(x: jnp.ndarray, means: jnp.ndarray, covs: jnp.ndarray) -> jnp.ndarray:
    """Score of the uniform-weight Gaussian mixture at x: [..., d] -> [..., d]."""
    logp = lambda xi: mixture_logdensity(xi, means, covs)
    g = jax.grad(logp)
    for _ in range(x.ndim - 1):
        g = jax.vmap(g)
    return g(x)
