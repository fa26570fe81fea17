"""PINN strong-form solver tests (FP inverse problem)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_inverse.config import Config, apply_overrides
from pde_inverse.methods_pinn import PINN
from pde_inverse.problems import FokkerPlanck


def _cfg(dim=2, extra=()):
    return apply_overrides(
        Config(),
        [
            "pde_instance.name=Fokker-Planck",
            f"pde_instance.domain_dim={dim}",
            "pde_instance.total_evolving_time=2",
            "solver.name=PINN",
            "solver.train.n_time_stamps=8",
            "solver.train.sample_per_time=128",
        ]
        + list(extra),
    )


class TestPINN:
    def test_residual_zero_at_truth(self, rng):
        """The strong-form residual must vanish when V_theta = V_true: the
        exact Gaussian law solves its own Fokker-Planck equation."""
        dim = 2
        cfg = _cfg(dim)
        inst = FokkerPlanck(cfg, rng)
        method = PINN(pde_instance=inst, cfg=cfg, rng=rng)
        net, _ = method.create_model_fn()
        params_true = {
            "params": {"F": {"kernel": inst.F / 2.0, "bias": jnp.zeros(dim)}}
        }

        t = jnp.float32(0.7)
        mean, cov = inst.moments(t)
        x = jax.random.normal(rng, (256, dim)) @ jnp.linalg.cholesky(cov).T + mean
        r = method._residual(net.apply, params_true, t, x)
        # r is a difference of O(1-10) terms; f32 cancellation floor ~1e-4
        assert float(jnp.sqrt(jnp.mean(r**2))) < 5e-3

    def test_registry_dispatch(self, rng):
        from pde_inverse.registry import get_method

        cfg = _cfg()
        assert get_method(cfg) is PINN

    def test_training_recovers_drift(self, rng):
        """A few hundred Adam steps on the PINN objective must pull the
        parametric drift toward the truth."""
        import optax

        dim = 2
        cfg = _cfg(dim)
        inst = FokkerPlanck(cfg, rng)
        method = PINN(pde_instance=inst, cfg=cfg, rng=rng)
        net, params = method.create_model_fn()
        opt = optax.adam(3e-2)

        @jax.jit
        def step(params, opt_state, key):
            out = method.value_and_grad_fn(net.apply, params, key)
            updates, opt_state = opt.update(out["grad"], opt_state, params)
            return optax.apply_updates(params, updates), opt_state, out

        opt_state = opt.init(params)
        init_err = float(inst.recovered_parameter_rel_l2(jax.device_get(params)))
        keys = jax.random.split(rng, 400)
        for k in keys:
            params, opt_state, out = step(params, opt_state, k)
        final_err = float(inst.recovered_parameter_rel_l2(jax.device_get(params)))
        assert np.isfinite(float(out["loss"]))
        assert final_err < 0.2 * init_err, (init_err, final_err)

    def test_learned_density_path(self, rng):
        """The learned-log-density branch (autodiff derivatives) runs and
        matches the oracle branch approximately when handed the exact
        Gaussian log-density as the 'learned' callable."""
        from pde_inverse.ops.gaussian import gaussian_logdensity

        dim = 2
        cfg = _cfg(dim)
        inst = FokkerPlanck(cfg, rng)
        method = PINN(pde_instance=inst, cfg=cfg, rng=rng)
        net, params = method.create_model_fn()

        t = jnp.float32(0.5)
        mean, cov = inst.moments(t)
        x = jax.random.normal(rng, (64, dim)) @ jnp.linalg.cholesky(cov).T + mean

        r_oracle = method._residual(net.apply, params, t, x)

        def log_density_fn(ti, xi):
            m, P = inst.moments(ti)
            return gaussian_logdensity(xi, m, P)

        method.log_density_fn = log_density_fn
        r_learned = method._residual(net.apply, params, t, x)
        np.testing.assert_allclose(r_oracle, r_learned, atol=2e-2, rtol=1e-3)


class TestPINNDispatchGuards:
    """registry.get_method must reject instance/solver combos the PINN
    cannot serve, with a clear error instead of an AttributeError deep in
    tracing."""

    def test_kinetic_gmm_rejected(self):
        from pde_inverse.registry import get_method

        cfg = apply_overrides(
            Config(),
            [
                "solver.name=PINN",
                "pde_instance.name=Kinetic-Fokker-Planck",
                "pde_instance.potential=GMM",
            ],
        )
        with pytest.raises(ValueError, match="Gaussian-path"):
            get_method(cfg)

    def test_kmv_rejected(self):
        from pde_inverse.registry import get_method

        cfg = apply_overrides(
            Config(),
            ["solver.name=PINN", "pde_instance.name=Kinetic-McKean-Vlasov"],
        )
        with pytest.raises(ValueError, match="mean-field"):
            get_method(cfg)

    def test_learned_density_requires_offline(self):
        from pde_inverse.registry import get_method

        cfg = apply_overrides(
            Config(),
            [
                "solver.name=PINN",
                "pde_instance.name=Fokker-Planck",
                "log_density.source=learned",
                "pde_instance.sample_mode=online",
            ],
        )
        with pytest.raises(ValueError, match="offline"):
            get_method(cfg)

    def test_learned_density_kinetic_rejected(self):
        from pde_inverse.registry import get_method

        cfg = apply_overrides(
            Config(),
            [
                "solver.name=PINN",
                "pde_instance.name=Kinetic-Fokker-Planck",
                "log_density.source=learned",
            ],
        )
        with pytest.raises(ValueError, match="overdamped"):
            get_method(cfg)


class TestLearnedDensityPipeline:
    """End-to-end: offline FP dataset -> RealNVP MLE -> PINN training with
    the learned flow (the reference's dormant main.py:50 intent)."""

    def test_cli_learned_density_runs(self, tmp_path):
        from pde_inverse.main import run

        cfg = apply_overrides(
            Config(),
            [
                "pde_instance.name=Fokker-Planck",
                "pde_instance.domain_dim=2",
                "pde_instance.sample_mode=offline",
                "pde_instance.sample_initial_size=512",
                "pde_instance.sample_terminal_size=512",
                "pde_instance.sample_0T_size=200",
                "pde_instance.n_steps_0T=20",
                "solver.name=PINN",
                "log_density.source=learned",
                "log_density.num_epochs=150",
                "log_density.lr_constant_steps=50",
                "log_density.lr_decay_end_step=120",
                "solver.train.n_time_stamps=4",
                "solver.train.sample_per_time=64",
                "train.number_of_iterations=60",
                "train.steps_per_chunk=30",
                "train.optimizer.learning_rate.initial=3e-2",
                "backend.use_mesh=False",
                "test.frequency=60",
                f"logging.run_dir={tmp_path}",
            ],
        )
        params = run(cfg)
        flat = jax.tree_util.tree_leaves(jax.device_get(params))
        assert all(np.isfinite(np.asarray(leaf)).all() for leaf in flat)


class TestPINNKinetic:
    def _setup(self, rng, dim=2):
        from pde_inverse.problems import KineticFokkerPlanckOU

        cfg = apply_overrides(
            Config(),
            [
                "pde_instance.name=Kinetic-Fokker-Planck",
                f"pde_instance.domain_dim={dim}",
                "pde_instance.total_evolving_time=2",
                "solver.name=PINN",
                "solver.train.n_time_stamps=8",
                "solver.train.sample_per_time=256",
            ],
        )
        from pde_inverse.methods_pinn import PINNKinetic

        inst = KineticFokkerPlanckOU(cfg, rng)
        method = PINNKinetic(pde_instance=inst, cfg=cfg, rng=rng)
        net, params = method.create_model_fn()
        return cfg, inst, method, net, params

    def test_registry_dispatch_kinetic(self, rng):
        from pde_inverse.methods_pinn import PINNKinetic
        from pde_inverse.registry import get_method

        cfg, *_ = self._setup(rng)
        assert get_method(cfg) is PINNKinetic

    def test_residual_zero_at_truth(self, rng):
        dim = 2
        cfg, inst, method, net, params = self._setup(rng, dim)
        params_true = {
            "params": {"F": {"kernel": inst.tilde_F / 2.0, "bias": jnp.zeros(dim)}}
        }
        t = jnp.float32(0.6)
        mean, cov = inst.oracle.moments(t)
        z = jax.random.normal(rng, (512, 2 * dim)) @ jnp.linalg.cholesky(cov).T + mean
        r = method._residual(net.apply, params_true, t, z)
        assert float(jnp.sqrt(jnp.mean(r**2))) < 5e-3, float(
            jnp.sqrt(jnp.mean(r**2))
        )

    def test_training_recovers_drift(self, rng):
        import optax

        cfg, inst, method, net, params = self._setup(rng)

        opt = optax.adam(3e-2)

        @jax.jit
        def step(params, opt_state, key):
            out = method.value_and_grad_fn(net.apply, params, key)
            updates, opt_state = opt.update(out["grad"], opt_state, params)
            return optax.apply_updates(params, updates), opt_state, out

        opt_state = opt.init(params)
        init_err = float(inst.recovered_parameter_rel_l2(jax.device_get(params)))
        for k in jax.random.split(rng, 400):
            params, opt_state, out = step(params, opt_state, k)
        final_err = float(inst.recovered_parameter_rel_l2(jax.device_get(params)))
        assert np.isfinite(float(out["loss"]))
        assert final_err < 0.2 * init_err, (init_err, final_err)
