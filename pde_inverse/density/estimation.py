"""Maximum-likelihood log-density estimation along the trajectory.

Capability parity with /root/reference/core/log_density_estimation.py:
train a time-conditioned RealNVP by MLE on the offline trajectory dataset
with strided time/trajectory minibatches and the reference's
constant -> cosine -> floor LR schedule.  The minibatch
subsampling (gather) and the flow loss run inside ONE jitted scan chunk,
with the epoch RNG as scan input — no per-epoch dispatch or host sync.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax

from pde_inverse.config import Config
from pde_inverse.density.flows import build_realnvp


def create_lr_schedule(lr: float, t0: int, t1: int):
    """Constant for t0 steps, cosine to lr*1e-2 until t1, floor after
    (parity: log_density_estimation.py:116-138)."""
    return optax.join_schedules(
        schedules=[
            optax.constant_schedule(lr),
            optax.cosine_decay_schedule(lr, t1 - t0, alpha=1e-2),
            optax.constant_schedule(lr * 1e-2),
        ],
        boundaries=[t0, t1],
    )


def estimate_log_density(
    cfg: Config,
    pde_instance,
    rng: jax.Array,
    steps_per_chunk: int = 200,
    verbose: bool = False,
) -> Callable:
    """Returns log_density_fn(t, x[batch]) after MLE training on
    pde_instance.dataset (offline mode required)."""
    ld = cfg.log_density
    dim = cfg.pde_instance.domain_dim
    if pde_instance.dataset is None:
        raise ValueError("log-density estimation requires an offline dataset")

    rng_init, rng_train = jax.random.split(rng)
    model = build_realnvp(
        pde_instance.distribution_initial_x.logdensity,
        dim,
        embed_time_dim=ld.embed_time_dim,
        couple_mul=ld.couple_mul,
        mask_type=ld.mask_type,
        activation=ld.activation,
        soft_init=ld.soft_init,
    )
    params = model.init(rng_init, jnp.zeros([]), jnp.zeros((1, dim)))

    schedule = create_lr_schedule(
        ld.learning_rate, ld.lr_constant_steps, ld.lr_decay_end_step
    )
    opt = optax.adam(learning_rate=schedule, b1=0.9, eps=1e-4)

    dataset = pde_instance.dataset["0T"]  # [n_traj, n_time, 2d]
    taus = pde_instance.dataset["tau_0T"]  # [n_traj, n_time]
    n_traj, n_time, _ = dataset.shape
    positions = dataset[..., :dim]
    stride_t, stride_n = 5, 5

    def minibatch(key, positions, taus):
        # positions/taus flow in as jit ARGUMENTS — closing over the full
        # trajectory store would bake it into the program as constants.
        key_t, key_n = jax.random.split(key)
        shift = jax.random.randint(key_t, [], 0, stride_t)
        t_idx = jnp.arange(n_time // stride_t) * stride_t + shift
        n_idx = jax.random.permutation(key_n, n_traj)[: n_traj // stride_n]
        x = positions[n_idx][:, t_idx]  # [n', t', d]
        t = taus[n_idx][:, t_idx]  # [n', t']
        return t, x

    def loss_fn(params, t, x):
        # model is batched over x's leading axes per fixed t; vmap the
        # per-trajectory time axis and the trajectory axis jointly.
        ll = jax.vmap(jax.vmap(lambda ti, xi: model.apply(params, ti, xi)))(t, x)
        return -jnp.mean(ll)

    def one_step(carry, key, positions, taus):
        params, opt_state = carry
        t, x = minibatch(key, positions, taus)
        loss, grad = jax.value_and_grad(loss_fn)(params, t, x)
        updates, opt_state = opt.update(grad, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    @jax.jit
    def chunk(carry, keys, positions, taus):
        body = lambda c, k: one_step(c, k, positions, taus)
        return jax.lax.scan(body, carry, keys)

    carry = (params, opt.init(params))
    n_epochs = ld.num_epochs
    keys = jax.random.split(rng_train, n_epochs)
    done = 0
    while done < n_epochs:
        k = min(steps_per_chunk, n_epochs - done)
        carry, losses = chunk(carry, keys[done : done + k], positions, taus)
        done += k
        if verbose:
            print(f"[density] epoch {done}: loss {float(losses[-1]):.4f}")
    params = carry[0]

    def log_density_fn(t, x):
        return model.apply(params, t, x)

    return log_density_fn
