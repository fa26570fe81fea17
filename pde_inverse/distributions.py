"""Probability primitives: sampling / score / log-density objects.

Capability parity with ``/root/reference/core/distribution.py`` (Gaussian,
GaussianMixture, Uniform, UniformMixture, DistributionKinetic,
Uniform over a ball, box-boundary uniforms).  Differences by design:

* All distributions are registered pytrees, so they can be closed over (or
  passed) inside jitted/sharded train steps without host round-trips.
* Gaussian sampling uses a precomputed Cholesky factor (one triangular
  matmul) instead of an SVD square root per construction.
* GMM log-density uses logsumexp instead of exp/mean/log.
* Mixture sampling assigns components with a vectorized categorical draw
  instead of a Python loop of per-component concatenations, so the batch is
  one fused gather (and the component assignment is exchangeable rather than
  block-ordered).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from pde_inverse.ops import gaussian as gops


class Distribution:
    """Interface: sample(n, key) / score(x) / logdensity(x) / density(x)."""

    def sample(self, batch_size: int, key: jax.Array) -> jnp.ndarray:
        raise NotImplementedError

    def score(self, x: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError

    def logdensity(self, x: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError

    def density(self, x: jnp.ndarray) -> jnp.ndarray:
        return jnp.exp(self.logdensity(x))


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class Gaussian(Distribution):
    mean: jnp.ndarray
    cov: jnp.ndarray
    chol: jnp.ndarray

    @classmethod
    def create(cls, mean: jnp.ndarray, cov: jnp.ndarray) -> "Gaussian":
        mean = jnp.asarray(mean)
        cov = jnp.asarray(cov)
        return cls(mean=mean, cov=cov, chol=jnp.linalg.cholesky(cov))

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]

    def sample(self, batch_size: int, key: jax.Array) -> jnp.ndarray:
        return gops.gaussian_sample(key, self.mean, self.chol, batch_size)

    def score(self, x: jnp.ndarray) -> jnp.ndarray:
        return gops.gaussian_score(x, self.mean, self.cov)

    def logdensity(self, x: jnp.ndarray) -> jnp.ndarray:
        return gops.gaussian_logdensity(x, self.mean, self.cov)

    def tree_flatten(self):
        return (self.mean, self.cov, self.chol), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class GaussianMixture(Distribution):
    """Uniform-weight Gaussian mixture. means [k, d], covs [k, d, d]."""

    means: jnp.ndarray
    covs: jnp.ndarray
    chols: jnp.ndarray

    @classmethod
    def create(cls, means: jnp.ndarray, covs: jnp.ndarray) -> "GaussianMixture":
        means = jnp.asarray(means)
        covs = jnp.asarray(covs)
        if covs.ndim == 1:  # scalar sigma per component -> isotropic
            d = means.shape[-1]
            covs = (covs[:, None, None] ** 2) * jnp.eye(d)
        return cls(means=means, covs=covs, chols=jnp.linalg.cholesky(covs))

    @property
    def n_components(self) -> int:
        return self.means.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[-1]

    def sample(self, batch_size: int, key: jax.Array) -> jnp.ndarray:
        key_comp, key_eps = jax.random.split(key)
        comp = jax.random.randint(key_comp, (batch_size,), 0, self.n_components)
        eps = jax.random.normal(key_eps, (batch_size, self.dim), dtype=self.means.dtype)
        chol_b = self.chols[comp]  # [n, d, d]
        mean_b = self.means[comp]  # [n, d]
        return jnp.einsum("nij,nj->ni", chol_b, eps) + mean_b

    def logdensity(self, x: jnp.ndarray) -> jnp.ndarray:
        return gops.mixture_logdensity(x, self.means, self.covs)

    def score(self, x: jnp.ndarray) -> jnp.ndarray:
        return gops.mixture_score(x, self.means, self.covs)

    def tree_flatten(self):
        return (self.means, self.covs, self.chols), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class Uniform(Distribution):
    """Uniform over an axis-aligned box (or scalar interval).

    mins/maxs: [] (scalar interval) or [d].
    (Parity: core/distribution.py:162-186.)
    """

    mins: jnp.ndarray
    maxs: jnp.ndarray

    @classmethod
    def create(cls, mins, maxs) -> "Uniform":
        return cls(mins=jnp.asarray(mins, jnp.float32), maxs=jnp.asarray(maxs, jnp.float32))

    @property
    def dim(self) -> int:
        return self.mins.shape[0] if self.mins.ndim == 1 else 0

    def sample(self, batch_size: int, key: jax.Array) -> jnp.ndarray:
        shape = (batch_size, self.dim) if self.dim else (batch_size,)
        return jax.random.uniform(
            key, shape, minval=self.mins, maxval=self.maxs, dtype=self.mins.dtype
        )

    def score(self, x: jnp.ndarray) -> jnp.ndarray:
        return jnp.zeros_like(x)

    def logdensity(self, x: jnp.ndarray) -> jnp.ndarray:
        log_vol = jnp.sum(jnp.log(self.maxs - self.mins))
        inside = jnp.all((x >= self.mins) & (x <= self.maxs), axis=-1)
        return jnp.where(inside, -log_vol, -jnp.inf)

    def tree_flatten(self):
        return (self.mins, self.maxs), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class BallUniform(Distribution):
    """Uniform over a d-dimensional L2 ball of radius r.
    (Generalizes core/distribution.py:86-94 beyond d=3.)"""

    radius: jnp.ndarray
    d: int = 3

    @classmethod
    def create(cls, radius, d: int = 3) -> "BallUniform":
        return cls(radius=jnp.asarray(radius, jnp.float32), d=d)

    def sample(self, batch_size: int, key: jax.Array) -> jnp.ndarray:
        return jax.random.ball(key, d=self.d, p=2, shape=(batch_size,)) * self.radius

    def score(self, x: jnp.ndarray) -> jnp.ndarray:
        return jnp.zeros_like(x)

    def tree_flatten(self):
        return (self.radius,), (self.d,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])


class UniformMixture(Distribution):
    """Equal-weight mixture of Uniform boxes (static list; host-side only).
    (Parity: core/distribution.py:189-203.)"""

    def __init__(self, uniforms: Sequence[Uniform]):
        if not uniforms:
            raise ValueError("UniformMixture needs at least one component")
        self.uniforms = list(uniforms)

    def sample(self, batch_size: int, key: jax.Array) -> jnp.ndarray:
        k = len(self.uniforms)
        if batch_size % k != 0:
            raise ValueError(f"batch_size must be a multiple of {k}")
        keys = jax.random.split(key, k)
        parts = [u.sample(batch_size // k, ki) for u, ki in zip(self.uniforms, keys)]
        return jnp.concatenate(parts, axis=0)


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class KineticProduct(Distribution):
    """Product law of independent position and velocity marginals,
    states concatenated as z = [x | v].
    (Parity: DistributionKinetic, core/distribution.py:25-50.)"""

    distribution_x: Distribution
    distribution_v: Distribution

    def sample(self, batch_size: int, key: jax.Array) -> jnp.ndarray:
        kx, kv = jax.random.split(key)
        x = self.distribution_x.sample(batch_size, kx)
        v = self.distribution_v.sample(batch_size, kv)
        return jnp.concatenate([x, v], axis=-1)

    def _split(self, z: jnp.ndarray):
        return jnp.split(z, 2, axis=-1)

    def score(self, z: jnp.ndarray) -> jnp.ndarray:
        x, v = self._split(z)
        return jnp.concatenate(
            [self.distribution_x.score(x), self.distribution_v.score(v)], axis=-1
        )

    def logdensity(self, z: jnp.ndarray) -> jnp.ndarray:
        x, v = self._split(z)
        return self.distribution_x.logdensity(x) + self.distribution_v.logdensity(v)

    def tree_flatten(self):
        return (self.distribution_x, self.distribution_v), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def box_boundary_uniforms(mins: jnp.ndarray, maxs: jnp.ndarray) -> list[Uniform]:
    """The 2d degenerate boxes forming the boundary faces of [mins, maxs].
    (Parity: core/distribution.py:206-225.)"""
    mins = jnp.asarray(mins)
    maxs = jnp.asarray(maxs)
    if mins.ndim != 1 or maxs.ndim != 1 or mins.shape != maxs.shape:
        raise ValueError("mins and maxs must be 1-D arrays of equal length")
    d = mins.shape[0]
    faces = []
    for i in range(d):
        e_i = jnp.zeros(d).at[i].set(1.0)
        # face at x_i = mins[i]
        faces.append(Uniform.create(mins, maxs + (mins[i] - maxs[i]) * e_i))
        # face at x_i = maxs[i]
        faces.append(Uniform.create(mins + (maxs[i] - mins[i]) * e_i, maxs))
    return faces
