"""Ground-truth potential objects (the physical quantity being recovered).

Capability parity with ``/root/reference/core/potential.py`` (Quadratic,
GMM, Void).  All are pytrees so they can be captured by jitted samplers.  ``value`` / ``gradient`` accept any leading batch
shape ``[..., d]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp


class Potential:
    def value(self, x: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError

    def gradient(self, x: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class QuadraticPotential(Potential):
    """V(x) = 1/2 (x - mu)^T cov^{-1} (x - mu).
    (Parity: core/potential.py:11-24.)"""

    mu: jnp.ndarray
    inv_cov: jnp.ndarray

    @classmethod
    def create(cls, mu: jnp.ndarray, cov: jnp.ndarray) -> "QuadraticPotential":
        return cls(mu=jnp.asarray(mu), inv_cov=jnp.linalg.inv(jnp.asarray(cov)))

    def value(self, x: jnp.ndarray) -> jnp.ndarray:
        u = x - self.mu
        return 0.5 * jnp.einsum("...i,ij,...j->...", u, self.inv_cov, u)

    def gradient(self, x: jnp.ndarray) -> jnp.ndarray:
        return (x - self.mu) @ self.inv_cov.T

    def tree_flatten(self):
        return (self.mu, self.inv_cov), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class GMMPotential(Potential):
    """V(x) = -logsumexp_k( -||x - mu_k||^2 / (2 sigma^2) ).

    Shared isotropic sigma across components (parity:
    core/potential.py:32-61).  The gradient is computed in closed form as a
    softmax-weighted sum of displacements — one [..., k] softmax plus one
    batched contraction, instead of autodiff through logsumexp.
    """

    mus: jnp.ndarray  # [k, d]
    sigma: jnp.ndarray  # []

    @classmethod
    def create(cls, mus: jnp.ndarray, sigma) -> "GMMPotential":
        return cls(mus=jnp.asarray(mus), sigma=jnp.asarray(sigma))

    def _energies(self, x: jnp.ndarray) -> jnp.ndarray:
        # [..., k]: -||x - mu_k||^2 / (2 sigma^2)
        diff = x[..., None, :] - self.mus  # [..., k, d]
        return -jnp.sum(diff * diff, axis=-1) / (2.0 * self.sigma**2)

    def value(self, x: jnp.ndarray) -> jnp.ndarray:
        return -jax.scipy.special.logsumexp(self._energies(x), axis=-1)

    def gradient(self, x: jnp.ndarray) -> jnp.ndarray:
        diff = x[..., None, :] - self.mus  # [..., k, d]
        w = jax.nn.softmax(self._energies(x), axis=-1)  # [..., k]
        return jnp.einsum("...k,...kd->...d", w, diff) / self.sigma**2

    def tree_flatten(self):
        return (self.mus, self.sigma), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class VoidPotential(Potential):
    """Zero potential (free dynamics). (Parity: core/potential.py:27-29.)"""

    def value(self, x: jnp.ndarray) -> jnp.ndarray:
        return jnp.zeros(x.shape[:-1], dtype=x.dtype)

    def gradient(self, x: jnp.ndarray) -> jnp.ndarray:
        return jnp.zeros_like(x)

    def tree_flatten(self):
        return (), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls()
