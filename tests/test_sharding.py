"""Mesh-sharding tests on the virtual 8-device CPU platform.

Gates (SURVEY.md §7 step 4): the sharded train step must (a) compile and run
over a real multi-device mesh, and (b) produce the same loss/grad as the
single-device path (GSPMD must only change layout, not semantics).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_inverse.config import BackendConfig, Config, apply_overrides
from pde_inverse.methods import ConsistencyBased
from pde_inverse.parallel.mesh import build_mesh
from pde_inverse.problems import KineticFokkerPlanckOU


def _cfg():
    return apply_overrides(
        Config(),
        [
            "pde_instance.name=Kinetic-Fokker-Planck",
            "pde_instance.domain_dim=2",
            "solver.train.sample_mode=grid_time",
            "solver.train.n_time_stamps=4",
            "solver.train.sample_per_time=64",
            "solver.train.batch_size_init=64",
            "solver.train.batch_size_terminal=64",
        ],
    )


@pytest.fixture
def setup(rng):
    cfg = _cfg()
    inst = KineticFokkerPlanckOU(cfg, rng)
    method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
    net, params = method.create_model_fn()
    return cfg, inst, method, net, params


class TestMesh:
    def test_eight_devices(self):
        assert jax.device_count() == 8

    def test_build_mesh_shapes(self):
        spec = build_mesh(BackendConfig())
        assert spec.n_data == 8 and spec.n_ref == 1
        spec2 = build_mesh(BackendConfig(data_axis_size=4, ref_axis_size=2))
        assert spec2.n_data == 4 and spec2.n_ref == 2

    def test_bad_factorization_raises(self):
        with pytest.raises(ValueError):
            build_mesh(BackendConfig(data_axis_size=3))


class TestShardedStep:
    def test_sharded_loss_matches_unsharded(self, setup, rng):
        cfg, inst, method, net, params = setup
        spec = build_mesh(BackendConfig())

        def vg(p, key):
            return method.value_and_grad_fn(net.apply, p, key)

        method.mesh_spec = None
        out_single = jax.jit(vg)(params, rng)

        method.mesh_spec = spec
        out_sharded = jax.jit(vg)(params, rng)

        np.testing.assert_allclose(
            out_single["loss"], out_sharded["loss"], rtol=1e-5
        )
        for a, b in zip(
            jax.tree_util.tree_leaves(out_single["grad"]),
            jax.tree_util.tree_leaves(out_sharded["grad"]),
        ):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)

    def test_batch_actually_sharded(self, setup, rng):
        cfg, inst, method, net, params = setup
        spec = build_mesh(BackendConfig())
        method.mesh_spec = spec

        def sample(key):
            return method.sample_data(key)["0T"]

        out = jax.jit(sample)(rng)
        # leading axis split over 8 devices
        assert len(out.sharding.device_set) == 8

    def test_mesh_shape_invariance(self, setup, rng):
        """Loss must be bit-identical across mesh shapes (deterministic RNG
        independent of the device layout)."""
        cfg, inst, method, net, params = setup

        losses = []
        for backend in [
            BackendConfig(data_axis_size=8),
            BackendConfig(data_axis_size=4, ref_axis_size=2),
            BackendConfig(data_axis_size=2, ref_axis_size=4),
        ]:
            method.mesh_spec = build_mesh(backend)
            out = jax.jit(
                lambda p, key: method.value_and_grad_fn(net.apply, p, key)
            )(params, rng)
            losses.append(float(out["loss"]))
        assert max(losses) - min(losses) < 1e-5 * max(1.0, abs(losses[0]))
