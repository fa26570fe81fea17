"""Overdamped Fokker-Planck inverse problem on an OU process.

Ground truth:  dX = -F X dt + sqrt(L) dW  with F symmetric PD drawn from a
fixed key, L = 2I (so the FPE Laplacian coefficient is 1), and
V_true(x) = 1/2 x^T F x.  The Gaussian path law comes from the spectral
closed form (``ops.ou.symmetric_ou_moments``), broadcast over every sampled
time in one fused program instead of the reference's per-sample vmapped
oracle (fokker_planck_example.py:84-96).

Parity: /root/reference/example_problems/fokker_planck_example.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pde_inverse.config import Config
from pde_inverse.distributions import Gaussian
from pde_inverse.models.parametric import QuadraticFormModel, recovered_quadratic_matrix
from pde_inverse.ops import ou
from pde_inverse.problems.base import ProblemInstance

# Fixed seed for the ground-truth drift, matching the reference's convention
# of a reproducible problem (fokker_planck_example.py:29).
_TRUTH_SEED = 2217


def make_configuration(dim: int):
    # typed key carries its impl, so the fixed-seed truth is identical
    # regardless of the backend.prng_impl default
    _F = jax.random.normal(
        jax.random.key(_TRUTH_SEED, impl="threefry2x32"), (dim, dim + 1)
    )
    F = _F @ _F.T  # symmetric PD => gradient field
    return {
        "F": F,
        "L": 2.0 * jnp.eye(dim),
        "m_0": jnp.ones(dim),
        "P_0": 5.0 * jnp.eye(dim),
    }


class FokkerPlanck(ProblemInstance):
    sample_scheme = "exact"

    def __init__(self, cfg: Config, rng: jax.Array):
        super().__init__(cfg, rng)
        c = make_configuration(self.dim)
        self.configuration = c
        self.F = c["F"]

        def moments(ts):
            return ou.symmetric_ou_moments(c["F"], c["L"], c["m_0"], c["P_0"], ts)

        self.moments = moments
        m0, P0 = moments(jnp.zeros([]))
        mT, PT = moments(self.total_evolving_time)
        self.distribution_initial = Gaussian.create(m0, P0)
        self.distribution_initial_x = self.distribution_initial
        self.distribution_terminal = Gaussian.create(mT, PT)
        self.dataset = None
        if self.sample_mode == "offline":
            self.dataset = jax.jit(self.generate_ground_truth_dataset)(
                jax.random.fold_in(rng, 17)
            )

    def V_true_fn(self, x: jnp.ndarray) -> jnp.ndarray:
        return 0.5 * jnp.einsum("...i,ij,...j->...", x, self.F, x)

    def sample_ground_truth(self, rng: jax.Array, batch_size: int) -> jnp.ndarray:
        """One sample at each of batch_size random times, fully batched:
        sample ts ~ U(1e-4, T), compute all (m(t), P(t)) via the broadcasted
        spectral oracle, batched-Cholesky, one fused affine sample."""
        rng_t, rng_x = jax.random.split(rng)
        ts = self.distribution_time.sample(batch_size, rng_t)
        means, covs = self.moments(ts)  # [n, d], [n, d, d]
        chols = jnp.linalg.cholesky(covs)
        eps = jax.random.normal(rng_x, (batch_size, self.dim))
        return jnp.einsum("nij,nj->ni", chols, eps) + means

    def get_time_sample_ground_truth(self, rng: jax.Array, batch_size: int):
        """Times matching sample_ground_truth under the same rng (the FP
        loss does not consume them, but the data policy provides them
        uniformly)."""
        rng_t, _ = jax.random.split(rng)
        return self.distribution_time.sample(batch_size, rng_t)

    def generate_ground_truth_dataset(self, rng: jax.Array) -> dict:
        """Offline dataset from the EXACT Gaussian path law (no SDE error):
        {initial [Ni, d], terminal [Nt, d], 0T [n_traj, n_time, d],
        tau_0T [n_traj, n_time]}.

        Each "trajectory" is a set of independent exact draws on its own
        phase-shifted time grid, mirroring the per-trajectory shifted grids
        of the reference's Langevin offline store (…GMM.py:187-202) so every
        time in (0, T] is reachable by the strided offline subsampler.  The
        reference has no offline mode for its overdamped instance; this one
        exists chiefly to feed the log-density-estimation -> PINN pipeline.
        """
        p = self.cfg.pde_instance
        rng_i, rng_t, rng_shift, rng_x = jax.random.split(rng, 4)
        n_traj, n_time = p.sample_0T_size, p.n_steps_0T
        dt = p.total_evolving_time / n_time

        dataset = {
            "initial": self.distribution_initial.sample(p.sample_initial_size, rng_i),
            "terminal": self.distribution_terminal.sample(
                p.sample_terminal_size, rng_t
            ),
        }
        # per-trajectory grids: tau[j, k] = (k+1) * dt - shift_j, shift in [0, dt)
        shifts = jax.random.uniform(rng_shift, (n_traj, 1), maxval=dt)
        taus = jnp.arange(1, n_time + 1) * dt - shifts  # [n_traj, n_time]
        means, covs = self.moments(taus.reshape(-1))  # [N, d], [N, d, d]
        chols = jnp.linalg.cholesky(covs)
        eps = jax.random.normal(rng_x, (n_traj * n_time, self.dim))
        x = jnp.einsum("nij,nj->ni", chols, eps) + means
        dataset["0T"] = x.reshape(n_traj, n_time, self.dim)
        dataset["tau_0T"] = taus
        return dataset

    def create_parametric_model(self):
        return QuadraticFormModel(dim=self.dim)

    def recovered_parameter_rel_l2(self, params):
        try:
            est = recovered_quadratic_matrix(params)
        except KeyError:  # non-parametric model: no physical parameter
            return None
        return jnp.linalg.norm(est - self.F) / jnp.linalg.norm(self.F)
