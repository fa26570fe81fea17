"""Kinetic Langevin simulation entry point with antithetic pairing.

One implementation on every platform: the ``lax.scan`` integrator in
ops/langevin.py, which accepts arbitrary potentials and traced
parameters.  It is gated distributionally against the exact OU law
(tests/test_langevin.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from pde_inverse.ops.langevin import simulate_kinetic_langevin
from pde_inverse.potentials import Potential


def simulate(
    key: jax.Array,
    z0: jnp.ndarray,
    n_steps: int,
    dt,
    potential: Potential,
    gamma: float,
    return_trajectory: bool = True,
    integrator: str = "euler",
    antithetic: bool = False,
    z0_mirror: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray], Optional[jnp.ndarray]]:
    """(final [n, 2d], trajectory [n, n_steps, 2d] | None, taus | None).

    integrator: "euler" (reference parity) or "baoab" (O(dt^2) weak error
    at the same one-force-eval-per-step cost).

    antithetic=True simulates EVERY z0 row twice — once with the Brownian
    increments, once with them negated (same per-particle random phase) —
    and concatenates the pair halves along the particle axis, so outputs
    have leading dim 2n for input n.  Each half is marginally an exact
    path sample; the pair is anticorrelated, reducing the variance of
    smooth path functionals at unchanged total simulation cost.  The +1
    half is bit-identical to a plain call with the same key (tested).

    z0_mirror (antithetic only): initial states for the mirrored half —
    pass the law-preserving reflection of z0 (e.g. 2*mean - z0 for a
    Gaussian initial law) so the INITIAL-state randomness is anticorrelated
    too; without it the pair shares z0 and the initial-draw component of
    the estimator variance is left on the table."""
    if z0_mirror is not None:
        if not antithetic:
            raise ValueError("z0_mirror is only meaningful with antithetic=True")
        if z0_mirror.shape != z0.shape:
            raise ValueError(
                f"z0_mirror shape {z0_mirror.shape} != z0 shape {z0.shape}"
            )
    signs = (1.0, -1.0) if antithetic else (1.0,)
    starts = (z0, z0_mirror if z0_mirror is not None else z0)
    outs = []
    for sign, z0 in zip(signs, starts):
        outs.append(
            simulate_kinetic_langevin(
                key,
                z0,
                n_steps,
                dt,
                potential.gradient,
                gamma,
                return_trajectory=return_trajectory,
                integrator=integrator,
                noise_sign=sign,
            )
        )
    if not antithetic:
        return outs[0]
    return tuple(
        None if a is None else jnp.concatenate([a, b], axis=0)
        for a, b in zip(*outs)
    )
