"""End-to-end log-density estimation test on a tiny offline KGMM dataset."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_inverse.config import Config, apply_overrides
from pde_inverse.density.estimation import create_lr_schedule, estimate_log_density
from pde_inverse.problems import KineticFokkerPlanckGMM


def _tiny_offline_cfg():
    return apply_overrides(
        Config(),
        [
            "pde_instance.name=Kinetic-Fokker-Planck",
            "pde_instance.potential=GMM",
            "pde_instance.domain_dim=2",
            "pde_instance.sample_mode=offline",
            "pde_instance.sample_initial_size=512",
            "pde_instance.sample_terminal_size=256",
            "pde_instance.sample_0T_size=128",
            "pde_instance.n_steps_terminal=20",
            "pde_instance.n_steps_0T=20",
            "pde_instance.total_evolving_time=1",
            "log_density.num_epochs=150",
            "log_density.lr_constant_steps=50",
            "log_density.lr_decay_end_step=120",
            "log_density.couple_mul=2",
            "log_density.embed_time_dim=4",
        ],
    )


class TestLogDensityEstimation:
    def test_lr_schedule_shape(self):
        sched = create_lr_schedule(1e-3, 100, 300)
        np.testing.assert_allclose(sched(0), 1e-3)
        np.testing.assert_allclose(sched(99), 1e-3)
        assert sched(250) < 1e-3
        np.testing.assert_allclose(sched(400), 1e-5, rtol=1e-2)

    def test_offline_dataset_and_estimation(self, rng):
        cfg = _tiny_offline_cfg()
        inst = KineticFokkerPlanckGMM(cfg, rng)
        assert inst.dataset is not None
        assert inst.dataset["initial"].shape == (512, 4)
        assert inst.dataset["terminal"].shape == (256, 4)
        assert inst.dataset["0T"].shape == (128, 20, 4)
        assert inst.dataset["tau_0T"].shape == (128, 20)

        log_density_fn = estimate_log_density(
            cfg, inst, jax.random.fold_in(rng, 1), steps_per_chunk=50
        )
        # higher likelihood at in-distribution points than far away
        x_in = inst.dataset["0T"][:32, 5, :2]
        x_out = jnp.full((32, 2), 40.0)
        t = jnp.float32(0.25)
        ll_in = jnp.mean(log_density_fn(t, x_in))
        ll_out = jnp.mean(log_density_fn(t, x_out))
        assert float(ll_in) > float(ll_out) + 10.0
