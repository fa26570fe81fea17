"""Problem-instance base class ("what PDE are we inverting").

Capability parity with the reference's ``ProblemInstance``
(``/root/reference/api.py:15-64``): each instance owns the ground-truth
dynamics, the initial/terminal/path distributions, exact or SDE sampling of
trajectory data, and (for parametric estimation) the hypothesis model whose
weights are the physical parameters.

All sampling methods are pure functions of (key, static sizes) so they can
be traced into the fused train step — data generation happens *inside* jit,
on device, every step.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp

from pde_inverse.config import Config
from pde_inverse.distributions import Distribution, Uniform

BatchSpec = Union[int, Tuple[int, int]]


class ProblemInstance:
    """Base problem. Subclasses must set distributions and implement sampling."""

    distribution_initial: Distribution
    distribution_initial_x: Distribution
    distribution_terminal: Optional[Distribution]
    instance_name: str

    # exact: closed-form Gaussian path law; SDE: Langevin simulation
    sample_scheme: str = "exact"
    sample_mode: str = "online"

    def __init__(self, cfg: Config, rng: jax.Array):
        self.cfg = cfg
        self.dim = cfg.pde_instance.domain_dim
        self.instance_name = f"{self.dim}D-{cfg.pde_instance.name}"
        self.diffusion_coefficient = jnp.asarray(
            cfg.pde_instance.diffusion_coefficient, jnp.float32
        )
        self.total_evolving_time = jnp.asarray(
            cfg.pde_instance.total_evolving_time, jnp.float32
        )
        # Time distribution starts at 1e-4 to avoid the degenerate t=0 law
        # (parity: api.py:35-37).
        self.distribution_time = Uniform.create(
            jnp.float32(1e-4), jnp.float32(cfg.pde_instance.total_evolving_time)
        )
        self.sample_mode = cfg.pde_instance.sample_mode

    # -- ground-truth coefficient being recovered --------------------------

    def V_true_fn(self, x: jnp.ndarray) -> jnp.ndarray:
        """True potential at x [..., d] -> [...]."""
        raise NotImplementedError

    # -- data sampling ------------------------------------------------------

    def sample_ground_truth(self, rng: jax.Array, batch_size: BatchSpec):
        """Sample path data at random (int spec) or gridded ((n_time,
        per_time) spec) times.  Grid mode returns samples laid out so that
        ``reshape(per_time, n_time, D)`` recovers (sample, time) axes."""
        raise NotImplementedError

    def get_time_sample_ground_truth(self, rng: jax.Array, batch_size: BatchSpec):
        """The time stamps matching ``sample_ground_truth`` under the same
        rng (parity: …OU.py:192-207 — the reference relies on rng reuse to
        align stamps with samples; we keep that contract)."""
        raise NotImplementedError

    def generate_ground_truth_dataset(self, rng: jax.Array) -> dict:
        """Offline mode: one-time dataset {initial, terminal, 0T, tau_0T}."""
        raise NotImplementedError

    def create_parametric_model(self):
        """Model (models/base.py) whose weights are the physical parameters."""
        raise NotImplementedError

    # -- diagnostics ----------------------------------------------------------

    def recovered_parameter_rel_l2(self, params) -> Optional[jnp.ndarray]:
        """Relative L2 error of the physically-recovered parameter (e.g. the
        drift matrix F~ or GMM means) for parametric models; None if not
        applicable.  This is the rebuild's headline accuracy metric
        (BASELINE.md north star)."""
        return None
