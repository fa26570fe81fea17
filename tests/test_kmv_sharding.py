"""Ref-axis (mean-field) sharding tests for the KMV pairwise loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_inverse.config import BackendConfig, Config, apply_overrides
from pde_inverse.losses import kinetic_mckean_vlasov as kmv_loss
from pde_inverse.parallel.mesh import build_mesh
from pde_inverse.problems import KineticMcKeanVlasovQuadratic


@pytest.fixture
def setup(rng):
    cfg = apply_overrides(
        Config(),
        [
            "pde_instance.name=Kinetic-McKean-Vlasov",
            "pde_instance.domain_dim=2",
            "pde_instance.total_evolving_time=1",
        ],
    )
    inst = KineticMcKeanVlasovQuadratic(cfg, rng)
    net = inst.create_parametric_model()
    params = net.init(jax.random.PRNGKey(0), jnp.zeros(2))
    n, nt = 48, 2
    data = {
        "0T": inst.sample_ground_truth(rng, (nt, n)),
        "tau_0T": inst.get_time_sample_ground_truth(rng, (nt, n)),
    }
    return inst, net, params, data


class TestKMVRefSharding:
    @pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4), (1, 8)])
    def test_sharded_loss_matches_local(self, setup, mesh_shape):
        inst, net, params, data = setup
        l_local = kmv_loss.make_loss_fn(net.apply, data, inst)
        spec = build_mesh(
            BackendConfig(data_axis_size=mesh_shape[0], ref_axis_size=mesh_shape[1])
        )
        l_shard = kmv_loss.make_loss_fn(net.apply, data, inst, mesh_spec=spec)
        loss_l, gap_l = jax.jit(l_local)(params)
        loss_s, gap_s = jax.jit(l_shard)(params)
        np.testing.assert_allclose(loss_l, loss_s, rtol=2e-5)
        np.testing.assert_allclose(gap_l, gap_s, rtol=2e-5, atol=1e-7)

    def test_sharded_grad_matches_local(self, setup):
        inst, net, params, data = setup
        l_local = kmv_loss.make_loss_fn(net.apply, data, inst)
        spec = build_mesh(BackendConfig(data_axis_size=2, ref_axis_size=4))
        l_shard = kmv_loss.make_loss_fn(net.apply, data, inst, mesh_spec=spec)
        g_local = jax.jit(jax.grad(lambda p: l_local(p)[0]))(params)
        g_shard = jax.jit(jax.grad(lambda p: l_shard(p)[0]))(params)
        for a, b in zip(
            jax.tree_util.tree_leaves(g_local), jax.tree_util.tree_leaves(g_shard)
        ):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)

    def test_indivisible_ref_axis_padding(self, setup, rng):
        """m = 50 not divisible by ref axis 8: padding + validity mask."""
        inst, net, params, data = setup
        n, nt = 50, 2
        data = {
            "0T": inst.sample_ground_truth(rng, (nt, n)),
            "tau_0T": inst.get_time_sample_ground_truth(rng, (nt, n)),
        }
        l_local = kmv_loss.make_loss_fn(net.apply, data, inst)
        spec = build_mesh(BackendConfig(data_axis_size=1, ref_axis_size=8))
        l_shard = kmv_loss.make_loss_fn(net.apply, data, inst, mesh_spec=spec)
        np.testing.assert_allclose(
            jax.jit(l_local)(params)[0], jax.jit(l_shard)(params)[0], rtol=2e-5
        )
