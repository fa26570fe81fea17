"""Consistency (weak-form) loss for the overdamped Fokker-Planck equation.

    loss = E_0T ||grad V||^2 - 2 E_0T [Laplacian V] + E_0T ||grad V_true||^2
         + (2 / T) ( E_term [V] - E_init [V] )

The Laplacian is computed as d batched HVP probes against basis vectors
(ops.autodiff.batched_laplacian) instead of a full jacfwd(grad) Jacobian
(reference fokker_planck.py:37-38).

Parity: /root/reference/methods/consistency_instances/fokker_planck.py:34-100.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pde_inverse.ops import autodiff as ad


def make_loss_fn(forward_fn, data, pde_instance):
    x_init = data["initial"]
    x_term = data["terminal"]
    x_0T = data["0T"]

    T = pde_instance.total_evolving_time
    nabla_V_true = ad.batched_grad(pde_instance.V_true_fn, x_0T)
    loss_nabla_true = jnp.mean(jnp.sum(nabla_V_true**2, axis=-1))

    def loss_fn(params):
        """Returns (loss, gap); the accuracy diagnostic shares the batched
        gradients with the loss instead of a second pass."""
        V = lambda x: forward_fn(params, x)[0]
        nabla_0T = ad.batched_grad(V, x_0T)
        loss_nabla = jnp.mean(jnp.sum(nabla_0T**2, axis=-1))
        loss_laplacian = jnp.mean(ad.batched_laplacian(V, x_0T))
        loss_initial = jnp.mean(ad.batched_value(V, x_init)) if x_init.shape[0] else 0.0
        loss_terminal = jnp.mean(ad.batched_value(V, x_term)) if x_term.shape[0] else 0.0
        loss = (loss_nabla - 2.0 * loss_laplacian + loss_nabla_true) + (
            2.0 * loss_terminal - 2.0 * loss_initial
        ) / T
        gap = jnp.mean(jnp.sum((nabla_V_true - nabla_0T) ** 2, axis=-1))
        return loss, gap

    return loss_fn


def value_and_grad_fn(forward_fn, params, data, rng, pde_instance, mesh_spec=None):
    loss_fn = make_loss_fn(forward_fn, data, pde_instance)
    (loss, gap), grad = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return {
        "loss": loss,
        "grad": grad,
        "grad_norm": ad.pytree_l2_norm(grad),
        "loss ground truth": gap,
    }


def test_fn(forward_fn, pde_instance, rng, batch_size: int = 10_000):
    """Relative L2 of grad V at initial/terminal samples
    (parity: fokker_planck.py:66-85)."""
    V = lambda x: forward_fn(x)[0]
    V_true = pde_instance.V_true_fn
    rng_i, rng_t = jax.random.split(rng)
    metrics = {}
    for name, dist, key in [
        ("initial", pde_instance.distribution_initial, rng_i),
        ("terminal", pde_instance.distribution_terminal, rng_t),
    ]:
        x = dist.sample(batch_size, key)
        pred = ad.batched_grad(V, x)
        true = ad.batched_grad(V_true, x)
        rel = jnp.sqrt(
            jnp.mean(jnp.sum((pred - true) ** 2, -1))
            / jnp.mean(jnp.sum(true**2, -1))
        )
        metrics[f"relative error of gradient estimation {name}"] = rel
    return metrics
