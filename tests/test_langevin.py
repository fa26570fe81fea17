"""Tests for the kinetic Langevin EM simulator.

Gate: for a quadratic potential the simulated law must match the exact
Gaussian OU moments from the Van Loan oracle (weak order-1 EM accuracy)."""

import jax
import jax.numpy as jnp
import numpy as np

from pde_inverse.ops import langevin as lv
from pde_inverse.ops import ou
from pde_inverse.potentials import QuadraticPotential


def _kinetic_setup(d=2, gamma=1.0):
    _F = jax.random.normal(jax.random.PRNGKey(2217), (d, d + 1))
    tilde_F = _F @ _F.T / d
    F = jnp.block([[jnp.zeros((d, d)), jnp.eye(d)], [-tilde_F, -gamma * jnp.eye(d)]])
    L = jnp.block(
        [[jnp.zeros((d, d)), jnp.zeros((d, d))], [jnp.zeros((d, d)), 2.0 * jnp.eye(d)]]
    )
    m0 = jnp.zeros(2 * d)
    P0 = jnp.eye(2 * d)
    return tilde_F, F, L, m0, P0


class TestLangevin:
    def test_shapes_and_time_stamps(self, rng):
        d, n, n_steps = 2, 64, 10
        dt = 0.05
        pot = QuadraticPotential.create(jnp.zeros(d), jnp.eye(d))
        z0 = jax.random.normal(rng, (n, 2 * d))
        final, traj, taus = lv.simulate_kinetic_langevin(
            rng, z0, n_steps, dt, pot.gradient, gamma=1.0
        )
        assert final.shape == (n, 2 * d)
        assert traj.shape == (n, n_steps, 2 * d)
        assert taus.shape == (n, n_steps)
        # taus[i] = tau0_i + k dt with tau0 in [0, dt)
        np.testing.assert_allclose(
            taus[:, 1:] - taus[:, :-1], dt, rtol=1e-5
        )
        assert (taus[:, 0] >= 0).all() and (taus[:, 0] < dt).all()

    def test_no_trajectory_mode(self, rng):
        d, n = 2, 32
        pot = QuadraticPotential.create(jnp.zeros(d), jnp.eye(d))
        z0 = jnp.zeros((n, 2 * d))
        final, traj, taus = lv.simulate_kinetic_langevin(
            rng, z0, 5, 0.1, pot.gradient, gamma=1.0, return_trajectory=False
        )
        assert traj is None and taus is None
        assert final.shape == (n, 2 * d)

    def test_quadratic_matches_ou_moments(self, rng):
        """EM simulation of the kinetic OU must reproduce the exact Gaussian
        moments at T (weak convergence gate)."""
        d = 2
        gamma = 1.0
        tilde_F, F, L, m0, P0 = _kinetic_setup(d, gamma)
        pot = QuadraticPotential.create(jnp.zeros(d), jnp.linalg.inv(tilde_F))

        T = 1.0
        n_steps = 400
        n = 100_000
        z0 = jax.random.normal(rng, (n, 2 * d))  # N(0, I) = N(m0, P0)
        final, _, _ = lv.simulate_kinetic_langevin(
            jax.random.fold_in(rng, 1), z0, n_steps, T / n_steps, pot.gradient, gamma
        )
        mean_exact, cov_exact = ou.lti_moments(F, L, m0, P0, jnp.float32(T))
        np.testing.assert_allclose(final.mean(0), mean_exact, atol=0.05)
        np.testing.assert_allclose(jnp.cov(final.T), cov_exact, atol=0.08)

    def test_baoab_bias_beats_euler_at_coarse_dt(self, rng):
        """BAOAB's weak error is O(dt^2) vs Euler-Maruyama's O(dt): at a
        deliberately coarse dt the terminal covariance bias of BAOAB must be
        several times smaller (both measured against the exact OU law with
        enough particles that MC noise is negligible)."""
        d = 2
        gamma = 1.0
        tilde_F, F, L, m0, P0 = _kinetic_setup(d, gamma)
        pot = QuadraticPotential.create(jnp.zeros(d), jnp.linalg.inv(tilde_F))

        T, n_steps, n = 1.0, 10, 400_000  # dt = 0.1, very coarse
        z0 = jax.random.normal(rng, (n, 2 * d))
        _, cov_exact = ou.lti_moments(F, L, m0, P0, jnp.float32(T))

        errs = {}
        for integrator in ("euler", "baoab"):
            final, _, _ = lv.simulate_kinetic_langevin(
                jax.random.fold_in(rng, 1),
                z0,
                n_steps,
                T / n_steps,
                pot.gradient,
                gamma,
                return_trajectory=False,
                random_phase=False,
                integrator=integrator,
            )
            cov = np.cov(np.asarray(final).T)
            errs[integrator] = np.linalg.norm(cov - cov_exact) / np.linalg.norm(
                cov_exact
            )
        assert errs["baoab"] < 0.4 * errs["euler"], errs
        assert errs["baoab"] < 0.02, errs


class TestAntithetic:
    """Antithetic Brownian pairing (ops/simulate.py antithetic=True)."""

    def test_plus_half_is_plain_run(self, rng):
        """The +1 half of an antithetic pair must be bit-identical to a
        plain simulate call with the same key (the pairing must not change
        the marginal path law)."""
        from pde_inverse.ops.simulate import simulate

        d, n, n_steps, dt = 2, 32, 8, 0.05
        pot = QuadraticPotential.create(jnp.zeros(d), jnp.eye(d))
        z0 = jax.random.normal(rng, (n, 2 * d))
        f_pair, t_pair, tau_pair = simulate(
            rng, z0, n_steps, dt, pot, 1.0, antithetic=True
        )
        f, t, tau = simulate(
            rng, z0, n_steps, dt, pot, 1.0, antithetic=False
        )
        assert f_pair.shape == (2 * n, 2 * d)
        np.testing.assert_array_equal(np.asarray(f_pair[:n]), np.asarray(f))
        np.testing.assert_array_equal(np.asarray(t_pair[:n]), np.asarray(t))
        # the mirrored half shares the phase draw => identical stamps
        np.testing.assert_array_equal(np.asarray(tau_pair[n:]), np.asarray(tau))

    def test_pair_mean_cancels_noise_exactly_when_force_free(self, rng):
        """Zero force, zero friction, Euler: states are linear in the
        Brownian increments, so the antithetic pair mean equals the
        noiseless drift trajectory q0 + t p0, p0 EXACTLY."""
        from pde_inverse.ops.simulate import simulate
        from pde_inverse.potentials import VoidPotential

        d, n, n_steps, dt = 2, 16, 12, 0.1
        z0 = jax.random.normal(rng, (n, 2 * d))
        final, traj, taus = simulate(
            jax.random.fold_in(rng, 1), z0, n_steps, dt, VoidPotential(),
            gamma=0.0, antithetic=True,
        )
        q0, p0 = z0[:, :d], z0[:, d:]
        # pair mean of the trajectory: [n, n_steps, 2d]
        mean_traj = 0.5 * (traj[:n] + traj[n:])
        t = taus[:n][..., None]
        np.testing.assert_allclose(
            np.asarray(mean_traj[..., :d]), np.asarray(q0[:, None] + t * p0[:, None]),
            rtol=1e-5, atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(mean_traj[..., d:]),
            np.broadcast_to(np.asarray(p0[:, None]), (n, n_steps, d)),
            rtol=1e-5, atol=1e-5,
        )
        mean_final = 0.5 * (final[:n] + final[n:])
        T = n_steps * dt
        np.testing.assert_allclose(
            np.asarray(mean_final[:, :d]), np.asarray(q0 + T * p0), rtol=1e-5, atol=1e-5
        )

    def test_variance_reduction_ou_mean(self, rng):
        """For the quadratic (OU) potential the antithetic estimator of
        E[q_T] (initial states mirrored around the zero mean, Brownian
        increments negated) has materially lower variance than iid
        sampling at the same total particle count."""
        from pde_inverse.ops.simulate import simulate

        d, n_pairs, n_steps, dt = 1, 64, 25, 0.04
        pot = QuadraticPotential.create(jnp.zeros(d), jnp.eye(d))
        reps = 48

        def estimate(key, antithetic):
            kz, ks = jax.random.split(key)
            n0 = n_pairs if antithetic else 2 * n_pairs
            z0 = jax.random.normal(kz, (n0, 2 * d))
            final, _, _ = simulate(
                ks, z0, n_steps, dt, pot, 1.0,
                return_trajectory=False, antithetic=antithetic,
                z0_mirror=-z0 if antithetic else None,
            )
            return jnp.mean(final[:, 0])

        keys = jax.random.split(rng, reps)
        est_anti = np.asarray(jax.vmap(lambda k: estimate(k, True))(keys))
        est_iid = np.asarray(jax.vmap(lambda k: estimate(k, False))(keys))
        assert est_anti.var() < 0.5 * est_iid.var(), (est_anti.var(), est_iid.var())

    def test_gmm_problem_antithetic_batches(self, rng):
        """Online SDE sampling with pde_instance.antithetic=True: shapes
        match the plain policy and the exact initial draws mirror around
        the initial mean."""
        from pde_inverse.config import Config, apply_overrides
        from pde_inverse.problems import KineticFokkerPlanckGMM

        cfg = apply_overrides(
            Config(),
            [
                "pde_instance.name=Kinetic-Fokker-Planck",
                "pde_instance.potential=GMM",
                "pde_instance.domain_dim=2",
                "pde_instance.sample_mode=online",
                "pde_instance.n_steps=10",
                "pde_instance.antithetic=True",
            ],
        )
        inst = KineticFokkerPlanckGMM(cfg, rng)
        batch = 8
        init, term, path = jax.jit(
            lambda k: inst.sample_ground_truth(k, batch)
        )(jax.random.fold_in(rng, 3))
        assert init.shape == (batch * inst.multiple_init, 2 * inst.dim)
        assert term.shape == (batch * inst.multiple_terminal, 2 * inst.dim)
        assert path.shape[0] == batch * 10
        h = init.shape[0] // 2
        m = np.asarray(inst.distribution_initial.mean)
        np.testing.assert_allclose(
            np.asarray(init[h:]), 2.0 * m - np.asarray(init[:h]), rtol=1e-6, atol=1e-6
        )

    def test_boundary_path_split_is_bitwise(self, rng):
        """sample_boundary_only + sample_path_only must reproduce the
        combined sample_ground_truth bitwise (shared 5-way key layout) —
        the chunk-cadence boundary refresh (solver.train.boundary_per_chunk)
        must not change the sampled law."""
        from pde_inverse.config import Config, apply_overrides
        from pde_inverse.problems import KineticFokkerPlanckGMM

        cfg = apply_overrides(
            Config(),
            [
                "pde_instance.name=Kinetic-Fokker-Planck",
                "pde_instance.potential=GMM",
                "pde_instance.domain_dim=2",
                "pde_instance.sample_mode=online",
                "pde_instance.n_steps=6",
            ],
        )
        inst = KineticFokkerPlanckGMM(cfg, rng)
        batch = 16
        k = jax.random.fold_in(rng, 5)
        init, term, path = jax.jit(lambda kk: inst.sample_ground_truth(kk, batch))(k)
        init2, term2 = jax.jit(lambda kk: inst.sample_boundary_only(kk, batch))(k)
        path2 = jax.jit(lambda kk: inst.sample_path_only(kk, batch))(k)
        np.testing.assert_array_equal(np.asarray(init), np.asarray(init2))
        np.testing.assert_array_equal(np.asarray(term), np.asarray(term2))
        np.testing.assert_array_equal(np.asarray(path), np.asarray(path2))
