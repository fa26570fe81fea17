"""Parametric hypothesis models: network weights ARE the physical parameters.

Parity targets:
* ``QuadraticFormModel`` — learn the drift matrix F~ (or interaction matrix
  A) as the kernel of one Dense layer, V(x) = x . Dense(x)
  (reference kinetic_fokker_planck_example_OU.py:209-220 and
  kinetic_mckean_vlasov_example_quadratic.py:205-216).
* ``GMMMeansModel`` — learn the K Gaussian means of a GMM potential
  (reference kinetic_fokker_planck_example_GMM.py:206-234).

Convention: models map a single point x [d] to a length-1 array, so the
scalar potential is ``forward_fn(params, x)[0]`` everywhere (matching the
reference's calling convention, methods/consistency_instances/*.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from pde_inverse.models.base import Module, Vars, dense
from pde_inverse.potentials import GMMPotential


@dataclass(frozen=True)
class QuadraticFormModel(Module):
    """V(x) = x . (W x + b); the learned symmetric part of W estimates F~."""

    dim: int

    def forward(self, v: Vars, x: jnp.ndarray) -> jnp.ndarray:
        y = dense(v.child("F"), x, self.dim)
        value = jnp.sum(x * y, axis=-1)
        return value[None] if x.ndim == 1 else value


@dataclass(frozen=True)
class GMMMeansModel(Module):
    """V(x) = GMM potential with learnable means (uniform weights, unit sigma)."""

    dim: int
    n_components: int

    def forward(self, v: Vars, x: jnp.ndarray) -> jnp.ndarray:
        mus = v.param(
            "mus",
            lambda key, shape: jax.random.normal(key, shape),
            (self.n_components, self.dim),
        )
        value = GMMPotential(mus=mus, sigma=jnp.ones([])).value(x)
        return value[None] if x.ndim == 1 else value


def recovered_quadratic_matrix(params) -> jnp.ndarray:
    """Extract the recovered symmetric matrix estimate from a
    QuadraticFormModel: V(x) = x^T W x  estimates  1/2 x^T F~ x, so
    F~_hat = W + W^T (the symmetric part doubled)."""
    kernel = params["params"]["F"]["kernel"]
    return kernel + kernel.T


def recovered_gmm_means(params) -> jnp.ndarray:
    return params["params"]["mus"]
