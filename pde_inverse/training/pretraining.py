"""Optional potential pretraining.

Capability parity with the reference's (written-but-never-called)
``potential_pretraining`` (methods/consistency_instances/fokker_planck.py:
103-148, kinetic_fokker_planck.py:107-157): warm-start the hypothesis
network by regressing its gradient onto a damped copy of the true gradient
over initial/terminal samples.  The whole SGD loop is one jitted
``lax.scan`` instead of 4096 Python-dispatched steps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import optax

from pde_inverse.ops import autodiff as ad


def potential_pretraining(
    pde_instance,
    forward_fn,
    params,
    rng: jax.Array,
    steps: int = 4096,
    batch_size: int = 2048,
    perturbation_rate: float = 0.1,
    learning_rate: float = 1e-3,
    kinetic: bool = True,
):
    """Returns pretrained params."""
    optimizer = optax.chain(
        optax.clip(1.0),
        optax.add_decayed_weights(1e-4),
        optax.sgd(learning_rate=learning_rate, momentum=0.9),
    )
    opt_state = optimizer.init(params)

    dist_i = pde_instance.distribution_initial
    dist_t = pde_instance.distribution_terminal

    def sample_x(key):
        k1, k2 = jax.random.split(key)
        data_i = dist_i.sample(batch_size, k1)
        data = (
            jnp.concatenate([data_i, dist_t.sample(batch_size, k2)], axis=0)
            if dist_t is not None
            else data_i
        )
        if kinetic:
            data = jnp.split(data, 2, axis=-1)[0]
        return data

    nabla_true = lambda x: ad.batched_grad(pde_instance.V_true_fn, x)

    def loss_fn(params, x):
        V = lambda xi: forward_fn(params, xi)[0]
        target = perturbation_rate * nabla_true(x)
        return jnp.mean(jnp.sum((ad.batched_grad(V, x) - target) ** 2, axis=-1))

    def step(carry, key):
        params, opt_state = carry
        x = sample_x(key)
        grad = jax.grad(loss_fn)(params, x)
        updates, opt_state = optimizer.update(grad, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), None

    @jax.jit
    def run(params, opt_state, keys):
        (params, _), _ = jax.lax.scan(step, (params, opt_state), keys)
        return params

    return run(params, opt_state, jax.random.split(rng, steps))
