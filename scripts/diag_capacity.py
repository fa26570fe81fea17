"""Capacity diagnostic for the non-parametric potential MLP.

Supervised fit of grad V_true for the KGMM potential (the same 3-mean GMM
the KGMM preset builds) with several architectures, reporting the gradient
rel-L2 on the KFP test distribution (x ~ N(0, 4I), d=4). This isolates
network capacity/optimization from the weak-form estimator: if supervised
training cannot reach <=1e-2 either, the non-parametric accuracy gap is a
capacity problem, not a loss/data problem.

Usage: python scripts/diag_capacity.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import optax

from pde_inverse.config import preset
from pde_inverse.models.mlp import PotentialMLP, ResNetPotential
from pde_inverse.ops import autodiff as ad
from pde_inverse.problems import KineticFokkerPlanckGMM
from pde_inverse.utils.cache import enable_compilation_cache

enable_compilation_cache()

cfg = preset("KGMM")
rng_problem = jax.random.split(jax.random.PRNGKey(cfg.seed), 4)[0]
inst = KineticFokkerPlanckGMM(cfg, rng_problem)
V_true = inst.V_true_fn
d = inst.dim

ARCHS = {
    "ref(32x2,f128,tanh)": PotentialMLP(hidden_dims=(32, 32), feature_dim=128),
    "wide(128x3,f256,tanh)": PotentialMLP(hidden_dims=(128, 128, 128), feature_dim=256),
    "fourier64-s0.5(64x2,f256)": PotentialMLP(
        hidden_dims=(64, 64), feature_dim=256, fourier_features=64, fourier_scale=0.5
    ),
    "fourier64-s1(64x2,f256)": PotentialMLP(
        hidden_dims=(64, 64), feature_dim=256, fourier_features=64, fourier_scale=1.0
    ),
    "fourier128-s1(128x2,f256,gelu)": PotentialMLP(
        hidden_dims=(128, 128),
        feature_dim=256,
        activation="gelu",
        fourier_features=128,
        fourier_scale=1.0,
    ),
    "fourier64-s2(64x2,f256)": PotentialMLP(
        hidden_dims=(64, 64), feature_dim=256, fourier_features=64, fourier_scale=2.0
    ),
    "fourier64-s1+quadhead": PotentialMLP(
        hidden_dims=(64, 64),
        feature_dim=256,
        fourier_features=64,
        fourier_scale=1.0,
        quadratic_head=True,
    ),
    "fourier64-s1+quadhead-wide": PotentialMLP(
        hidden_dims=(128, 128),
        feature_dim=256,
        fourier_features=64,
        fourier_scale=1.0,
        quadratic_head=True,
    ),
}

N_STEPS = 20_000
BATCH = 4096
CHUNK = 1000


def run(name, net):
    params = net.init(jax.random.PRNGKey(11), jnp.zeros((d,)))
    sched = optax.cosine_decay_schedule(1e-2, N_STEPS, 1e-3)
    opt = optax.adam(sched, eps=1e-4)

    def loss_fn(params, key):
        x = 2.0 * jax.random.normal(key, (BATCH, d))
        V = lambda xi: net.apply(params, xi)[0]
        g = ad.batched_grad(V, x)
        gt = ad.batched_grad(V_true, x)
        return jnp.mean(jnp.sum((g - gt) ** 2, axis=-1))

    def step(carry, key):
        params, opt_state = carry
        loss, grad = jax.value_and_grad(loss_fn)(params, key)
        updates, opt_state = opt.update(grad, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    @jax.jit
    def chunk(carry, keys):
        return jax.lax.scan(step, carry, keys)

    carry = (params, opt.init(params))
    keys = jax.random.split(jax.random.PRNGKey(3), N_STEPS)
    for i in range(0, N_STEPS, CHUNK):
        carry, losses = chunk(carry, keys[i : i + CHUNK])
    params = carry[0]

    xt = 2.0 * jax.random.normal(jax.random.PRNGKey(99), (50_000, d))
    V = lambda xi: net.apply(params, xi)[0]
    g = ad.batched_grad(V, xt)
    gt = ad.batched_grad(V_true, xt)
    rel = jnp.sqrt(jnp.mean(jnp.sum((g - gt) ** 2, -1)) / jnp.mean(jnp.sum(gt**2, -1)))
    print(f"{name:28s} supervised grad rel-L2 = {float(rel):.3e}", flush=True)


for name, net in ARCHS.items():
    run(name, net)
