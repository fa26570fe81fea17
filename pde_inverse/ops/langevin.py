"""Euler-Maruyama underdamped (kinetic) Langevin simulator.

Reference semantics (``/root/reference/utils/sampling_utils.py:6-52``):
    p <- p - dt * grad_U(q) + sqrt(2 dt) * xi - gamma * p * dt
    q <- q + dt * p_new
with a per-particle random initial phase tau0 ~ U[0, dt) so every time stamp
in [0, T] is reachable, a trajectory of n_steps states at times
tau0 + k * dt, and a final partial step of (dt - tau0) landing exactly at
T = n_steps * dt.

Batched layout: the reference vmaps a per-particle ``lax.scan`` over
scalar states; here the scan carries the whole particle batch ``[n, d]`` so
each step is a handful of fused [n, d] elementwise ops and one batched
noise draw — no per-particle program.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp


def kinetic_langevin_step(
    q: jnp.ndarray,
    p: jnp.ndarray,
    noise: jnp.ndarray,
    dt: jnp.ndarray,
    grad_potential: Callable[[jnp.ndarray], jnp.ndarray],
    gamma: float,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One EM step; dt may be scalar or per-particle [n] (broadcast).

    noise: standard normal, same shape as p.
    """
    dt_col = jnp.asarray(dt)[..., None] if jnp.ndim(dt) == 1 else dt
    sqrt_2dt = jnp.sqrt(2.0 * dt_col)
    p_new = p - dt_col * grad_potential(q) + sqrt_2dt * noise - gamma * p * dt_col
    q_new = q + dt_col * p_new
    return q_new, p_new


def baoab_step(
    q: jnp.ndarray,
    p: jnp.ndarray,
    g: jnp.ndarray,
    noise: jnp.ndarray,
    dt: jnp.ndarray,
    grad_potential: Callable[[jnp.ndarray], jnp.ndarray],
    gamma: float,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One BAOAB splitting step (Leimkuhler-Matthews) for
    dq = p dt, dp = -(grad U + gamma p) dt + sqrt(2) dW.

    Weak error O(dt^2) vs Euler-Maruyama's O(dt) at the SAME cost: the
    force at the step's end q is returned and reused as the next step's
    opening B half-kick (g carries grad U(q)).  The O block is the exact
    OU solve: p <- c1 p + c2 xi with c1 = e^{-gamma dt},
    c2 = sqrt((1 - c1^2)/gamma) (stationary velocity variance 1/gamma for
    the sqrt(2) noise scale); gamma -> 0 recovers c2 = sqrt(2 dt).
    """
    dt_col = jnp.asarray(dt)[..., None] if jnp.ndim(dt) == 1 else jnp.asarray(dt)
    half = 0.5 * dt_col
    p = p - half * g
    q = q + half * p
    if gamma > 0.0:
        c1 = jnp.exp(-gamma * dt_col)
        c2 = jnp.sqrt((1.0 - c1 * c1) / gamma)
    else:
        c1, c2 = 1.0, jnp.sqrt(2.0 * dt_col)
    p = c1 * p + c2 * noise
    q = q + half * p
    g = grad_potential(q)
    p = p - half * g
    return q, p, g


def simulate_kinetic_langevin(
    key: jax.Array,
    z0: jnp.ndarray,
    n_steps: int,
    dt: jnp.ndarray,
    grad_potential: Callable[[jnp.ndarray], jnp.ndarray],
    gamma: float,
    return_trajectory: bool = True,
    random_phase: bool = True,
    integrator: str = "euler",
    noise_sign: float = 1.0,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray], Optional[jnp.ndarray]]:
    """Simulate the kinetic Langevin SDE from z0 = [q0 | p0], [n, 2d].

    noise_sign flips every Brownian increment (the phase draw is
    unaffected): two calls with the SAME key and signs +1/-1 yield an
    antithetic trajectory pair — each marginally exact, jointly
    anticorrelated (variance reduction for smooth path functionals).

    Returns (final_state [n, 2d], trajectory [n, n_steps, 2d] or None,
    taus [n, n_steps] or None).  trajectory[i, k] is the state of particle i
    at time taus[i, k] = tau0_i + k * dt; final_state is at exactly
    n_steps * dt.  grad_potential maps [n, d] -> [n, d].

    integrator: "euler" (reference parity, utils/sampling_utils.py:6-22) or
    "baoab" (O(dt^2) weak error at the same one-force-per-step cost).
    """
    if integrator not in ("euler", "baoab"):
        raise ValueError(f"unknown integrator {integrator!r}")
    n = z0.shape[0]
    d = z0.shape[-1] // 2
    q0, p0 = z0[:, :d], z0[:, d:]

    key_phase, key_steps = jax.random.split(key)
    if random_phase:
        tau0 = jax.random.uniform(key_phase, (n,), dtype=z0.dtype) * dt
    else:
        tau0 = jnp.zeros((n,), dtype=z0.dtype)

    step_keys = jax.random.split(key_steps, n_steps + 1)

    def noise(k):
        return noise_sign * jax.random.normal(k, (n, d), dtype=z0.dtype)

    if integrator == "euler":
        step = lambda q, p, g, xi, sdt: (
            *kinetic_langevin_step(q, p, xi, sdt, grad_potential, gamma),
            g,
        )
        g0 = jnp.zeros_like(p0)  # unused by euler
    else:
        step = lambda q, p, g, xi, sdt: baoab_step(
            q, p, g, xi, sdt, grad_potential, gamma
        )
        g0 = grad_potential(q0)

    # Phase step of length tau0 (per particle) lands on the first grid time.
    q, p, g = step(q0, p0, g0, noise(step_keys[0]), tau0)

    def body(carry, k):
        q, p, g = carry
        q, p, g = step(q, p, g, noise(k), dt)
        out = jnp.concatenate([q, p], axis=-1) if return_trajectory else None
        return (q, p, g), out

    (q_mid, p_mid, g_mid), tail = jax.lax.scan(body, (q, p, g), step_keys[1:n_steps])

    # Closing partial step of (dt - tau0) completes exactly n_steps * dt.
    q_fin, p_fin, _ = step(q_mid, p_mid, g_mid, noise(step_keys[n_steps]), dt - tau0)
    final_state = jnp.concatenate([q_fin, p_fin], axis=-1)

    if not return_trajectory:
        return final_state, None, None

    first = jnp.concatenate([q, p], axis=-1)[None]  # [1, n, 2d]
    trajectory = jnp.concatenate([first, tail], axis=0)  # [n_steps, n, 2d]
    trajectory = jnp.swapaxes(trajectory, 0, 1)  # [n, n_steps, 2d]
    taus = tau0[:, None] + jnp.arange(n_steps, dtype=z0.dtype)[None, :] * dt
    return final_state, trajectory, taus
