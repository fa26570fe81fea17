"""Kinetic Fokker-Planck inverse problem on a kinetic OU process.

Ground truth: the underdamped Langevin dynamics with quadratic potential
V_true(x) = 1/2 x^T F~ x and friction gamma,
    dz = F z dt + sqrt(L) dW,   F = [[0, I], [-F~, -gamma I]],
    L = diag(0, 2I)
(so the velocity-Laplacian coefficient of the kinetic FPE is 1).  The path
law is Gaussian; moments come from the exact Van Loan matrix-exponential
oracle (``ops.ou.lti_moments``) instead of the reference's odeint-inside-
the-traced-step (kinetic_fokker_planck_example_OU.py:73-93,147-156).

Grid-time sampling supports any number of time stamps — the reference
asserts n_time_stamps == 1 because its reshape scrambles (sample, time)
axes for n > 1 (…OU.py:176-190); here the layout is an explicit transpose.

Parity: /root/reference/example_problems/kinetic_fokker_planck_example_OU.py.
"""

from __future__ import annotations

from typing import Tuple, Union

import jax
import jax.numpy as jnp

from pde_inverse.config import Config
from pde_inverse.distributions import Gaussian
from pde_inverse.models.parametric import QuadraticFormModel, recovered_quadratic_matrix
from pde_inverse.ops import ou
from pde_inverse.problems.base import BatchSpec, ProblemInstance

_TRUTH_SEED = 2217


def make_configuration(dim: int, gamma: float = 1.0):
    # typed key carries its impl, so the fixed-seed truth is identical
    # regardless of the backend.prng_impl default
    _F = jax.random.normal(
        jax.random.key(_TRUTH_SEED, impl="threefry2x32"), (dim, dim + 1)
    )
    tilde_F = _F @ _F.T  # symmetric => gradient field
    zeros = jnp.zeros((dim, dim))
    eye = jnp.eye(dim)
    F = jnp.block([[zeros, eye], [-tilde_F, -gamma * eye]])
    L = jnp.block([[zeros, zeros], [zeros, 2.0 * eye]])
    m_0 = jnp.zeros(2 * dim)
    P_0 = jnp.block([[eye, zeros], [zeros, eye]])
    return {
        "gamma_friction": gamma,
        "tilde_F": tilde_F,
        "F": F,
        "L": L,
        "m_0": m_0,
        "P_0": P_0,
        "m_x_0": jnp.zeros(dim),
        "P_x_0": eye,
    }


class KineticFokkerPlanckOU(ProblemInstance):
    sample_scheme = "exact"

    def __init__(self, cfg: Config, rng: jax.Array):
        super().__init__(cfg, rng)
        broaden = cfg.pde_instance.init_broaden
        if broaden < 1.0:
            raise ValueError("pde_instance.init_broaden must be >= 1.0")
        if broaden > 1.0 and self.sample_mode != "online":
            raise ValueError(
                "pde_instance.init_broaden reweights ONLINE sampling; "
                "offline datasets are drawn from the true law"
            )
        c = make_configuration(self.dim)
        self.configuration = c
        self.gamma_friction = c["gamma_friction"]
        self.tilde_F = c["tilde_F"]
        self.oracle = ou.GaussianPathOracle.create(
            c["F"], c["L"], c["m_0"], c["P_0"]
        )
        self.distribution_initial = Gaussian.create(c["m_0"], c["P_0"])
        self.distribution_initial_x = Gaussian.create(c["m_x_0"], c["P_x_0"])
        mT, PT = self.oracle.moments(self.total_evolving_time)
        self.distribution_terminal = Gaussian.create(mT, PT)
        self.dataset = None
        if self.sample_mode == "offline":
            self.dataset = jax.jit(self.generate_ground_truth_dataset)(
                jax.random.fold_in(rng, 17)
            )

    # -- truth ---------------------------------------------------------------

    def V_true_fn(self, x: jnp.ndarray) -> jnp.ndarray:
        return 0.5 * jnp.einsum("...i,ij,...j->...", x, self.tilde_F, x)

    # -- sampling ------------------------------------------------------------

    def _grid_times(self, rng: jax.Array, n_time_stamps: int) -> jnp.ndarray:
        """Stratified random stamps: stamp i ~ i*T/n + U[0, T/n).
        (Parity: …OU.py:158-173 time-shift scheme.)"""
        shift = jax.random.uniform(rng, (n_time_stamps,)) * (
            self.total_evolving_time / n_time_stamps
        )
        base = jnp.linspace(0.0, float(self.total_evolving_time), n_time_stamps + 1)[
            :-1
        ]
        return base + shift

    def _sample_at_times(
        self, rng: jax.Array, ts: jnp.ndarray, per_time: int
    ) -> jnp.ndarray:
        """[per_time, n_time, D] samples from the exact Gaussian law at ts."""
        means, covs = self.oracle.moments_grid(ts)  # [nt, D], [nt, D, D]
        chols = jnp.linalg.cholesky(covs)
        eps = jax.random.normal(rng, (per_time, ts.shape[0], 2 * self.dim))
        return jnp.einsum("tij,ntj->nti", chols, eps) + means

    def sample_ground_truth(self, rng: jax.Array, batch_size: BatchSpec):
        if isinstance(batch_size, int):
            # random-time mode: batch // per_time distinct times, a block of
            # samples at each (parity: …OU.py:141-156, per_time = 100).
            per_time = 100
            if batch_size < 2 * per_time:
                raise ValueError("random-time mode needs batch_size >= 200")
            n_times = batch_size // per_time
            rng_t, rng_x = jax.random.split(rng)
            ts = self.distribution_time.sample(n_times, rng_t)
        else:
            n_times, per_time = batch_size
            rng_t, rng_x = jax.random.split(rng)
            ts = self._grid_times(rng_t, n_times)
        samples = self._sample_at_times(rng_x, ts, per_time)  # [p, nt, D]
        return samples.reshape(-1, 2 * self.dim)

    def get_time_sample_ground_truth(self, rng: jax.Array, batch_size: BatchSpec):
        """Time stamps aligned with sample_ground_truth under the same rng."""
        rng_t, _ = jax.random.split(rng)
        if isinstance(batch_size, int):
            return self.distribution_time.sample(batch_size // 100, rng_t)
        return self._grid_times(rng_t, batch_size[0])

    def sample_ground_truth_weighted(
        self, rng: jax.Array, batch_size: BatchSpec, s=None
    ):
        """Tail-boost sampling for exact-law instances
        (pde_instance.init_broaden = s > 1): grid-time samples drawn from
        the s-broadened law q_t = N(m_t, s^2 P_t) with exact per-(sample,
        stamp) importance weights computed from the sampling noise itself:
        z = m_t + s L_t eps with eps ~ N(0, I) gives

            w = p_t(z) / q_t(z) = s^D exp(-(s^2 - 1) ||eps||^2 / 2) <= s^D

        (D = 2 dim), so every weighted stamp expectation is an unbiased
        estimate of the true-law expectation while the sampler covers the
        law's tail ~s^2 x more densely.  Same rng layout as
        sample_ground_truth — get_time_sample_ground_truth stays aligned,
        and s = 1 reproduces the unweighted samples bitwise.  grid_time
        only (the random-time mode has no batch layout for weights).
        The optional ``s`` argument overrides the config dose with a
        (possibly traced) per-step scalar — the annealed-dose schedule
        (pde_instance.init_broaden_decay_steps); the weight formula is
        exact at every s, so the estimator stays unbiased step-by-step.
        Returns {"0T" [n*nt, D], "w_0T" [n*nt]} flat and aligned.
        Reference analogue: none (it samples the true law only,
        …OU.py:158-190)."""
        if isinstance(batch_size, int):
            raise ValueError(
                "pde_instance.init_broaden needs grid_time sampling for "
                "exact-law instances (solver.train.sample_mode=grid_time)"
            )
        if s is None:
            s = self.cfg.pde_instance.init_broaden
        n_times, per_time = batch_size
        rng_t, rng_x = jax.random.split(rng)
        ts = self._grid_times(rng_t, n_times)
        means, covs = self.oracle.moments_grid(ts)
        chols = jnp.linalg.cholesky(covs)
        D = 2 * self.dim
        eps = jax.random.normal(rng_x, (per_time, n_times, D))
        z = s * jnp.einsum("tij,ntj->nti", chols, eps) + means
        logw = D * jnp.log(s) - 0.5 * (s**2 - 1.0) * jnp.sum(eps**2, axis=-1)
        return {"0T": z.reshape(-1, D), "w_0T": jnp.exp(logw).reshape(-1)}

    # -- offline dataset ---------------------------------------------------------

    # Number of distinct phase-shifted time grids shared among trajectories
    # (the exact-law analogue of the reference's per-trajectory shifted
    # Langevin grids, …GMM.py:187-202; grouping bounds the moment-oracle
    # evaluations at G*n_time instead of n_traj*n_time).
    _N_SHIFT_GROUPS = 64

    def generate_ground_truth_dataset(self, rng: jax.Array) -> dict:
        """{initial [Ni, 2d], terminal [Nt, 2d], 0T [n_traj, n_time, 2d],
        tau_0T [n_traj, n_time]} drawn from the EXACT Gaussian path law (no
        SDE discretization error).  Neither the reference nor round 1 had an
        offline mode for the OU-family instances; this one enables offline
        consistency training AND offline KMV (whose loss consumes the
        per-trajectory stamps as 'tau_0T_per_traj')."""
        p = self.cfg.pde_instance
        rng_i, rng_t, rng_shift, rng_x = jax.random.split(rng, 4)
        n_traj, n_time = p.sample_0T_size, p.n_steps_0T
        D = 2 * self.dim
        dt = p.total_evolving_time / n_time

        dataset = {
            "initial": self.distribution_initial.sample(p.sample_initial_size, rng_i),
            "terminal": self.distribution_terminal.sample(
                p.sample_terminal_size, rng_t
            ),
        }

        G = min(n_traj, self._N_SHIFT_GROUPS)
        reps = -(-n_traj // G)  # trajectories per group (last group padded)
        shifts = jax.random.uniform(rng_shift, (G, 1), maxval=dt)
        taus_g = jnp.arange(1, n_time + 1) * dt - shifts  # [G, n_time]
        means, covs = self.oracle.moments_grid(taus_g.reshape(-1))
        chols = jnp.linalg.cholesky(covs).reshape(G, n_time, D, D)
        means = means.reshape(G, n_time, D)
        eps = jax.random.normal(rng_x, (G, reps, n_time, D))
        z = jnp.einsum("gtij,grtj->grti", chols, eps) + means[:, None]
        # interleave groups so trajectory j uses grid j % G
        z = z.transpose(1, 0, 2, 3).reshape(-1, n_time, D)[:n_traj]
        taus = jnp.tile(taus_g, (reps, 1))[:n_traj]
        dataset["0T"] = z
        dataset["tau_0T"] = taus
        # Group structure for the KMV offline weight oracle: trajectory j
        # uses grid j % G (the interleave above), so consumers can evaluate
        # the per-stamp moment oracle once per (group, stamp) instead of
        # once per (trajectory, stamp) element — G*n_time evaluations
        # instead of n_traj*n_time (losses/kinetic_mckean_vlasov.
        # compute_weights_grouped).  The leading axis gives G statically.
        dataset["tau_groups"] = taus_g
        return dataset

    # -- models ----------------------------------------------------------------

    def create_parametric_model(self):
        return QuadraticFormModel(dim=self.dim)

    def recovered_parameter_rel_l2(self, params):
        try:
            est = recovered_quadratic_matrix(params)
        except KeyError:  # non-parametric model: no physical parameter
            return None
        return jnp.linalg.norm(est - self.tilde_F) / jnp.linalg.norm(self.tilde_F)
