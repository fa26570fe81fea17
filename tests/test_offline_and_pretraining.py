"""Offline data policy, pretraining, plotting, and non-parametric tests."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_inverse.config import Config, apply_overrides
from pde_inverse.methods import ConsistencyBased
from pde_inverse.problems import KineticFokkerPlanckGMM, KineticFokkerPlanckOU
from pde_inverse.training.pretraining import potential_pretraining


def _offline_cfg(extra=()):
    return apply_overrides(
        Config(),
        [
            "pde_instance.name=Kinetic-Fokker-Planck",
            "pde_instance.potential=GMM",
            "pde_instance.domain_dim=2",
            "pde_instance.sample_mode=offline",
            "pde_instance.sample_initial_size=256",
            "pde_instance.sample_terminal_size=128",
            "pde_instance.sample_0T_size=64",
            "pde_instance.n_steps_terminal=10",
            "pde_instance.n_steps_0T=25",
            "pde_instance.total_evolving_time=1",
        ]
        + list(extra),
    )


class TestOfflinePolicy:
    def test_offline_subsampling(self, rng):
        cfg = _offline_cfg()
        inst = KineticFokkerPlanckGMM(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        data = method.sample_data(rng)
        # stride 5 in both axes: 64//5=12 trajectories x 25//5=5 stamps
        assert data["0T"].shape == (12 * 5, 4)
        assert data["initial"].shape == (256, 4)
        assert data["terminal"].shape == (128, 4)

    def test_offline_training_step(self, rng):
        cfg = _offline_cfg()
        inst = KineticFokkerPlanckGMM(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        net, params = method.create_model_fn()
        out = jax.jit(
            lambda p, k: method.value_and_grad_fn(net.apply, p, k)
        )(params, rng)
        assert np.isfinite(float(out["loss"]))

    def test_nonparametric_model_offline(self, rng):
        cfg = _offline_cfg(["estimation_mode=non-parametric"])
        inst = KineticFokkerPlanckGMM(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        net, params = method.create_model_fn()
        # MLP potential: scalar >= 0 output
        x = jnp.zeros(2)
        v = net.apply(params, x)
        assert v.shape == (1,) and float(v[0]) >= 0
        out = jax.jit(
            lambda p, k: method.value_and_grad_fn(net.apply, p, k)
        )(params, rng)
        assert np.isfinite(float(out["loss"]))


class TestPretraining:
    def test_pretraining_moves_gradient_toward_damped_truth(self, rng):
        cfg = apply_overrides(
            Config(),
            [
                "pde_instance.name=Kinetic-Fokker-Planck",
                "pde_instance.domain_dim=2",
            ],
        )
        inst = KineticFokkerPlanckOU(cfg, rng)
        net = inst.create_parametric_model()
        params = net.init(jax.random.PRNGKey(0), jnp.zeros(2))
        pre = potential_pretraining(
            inst, net.apply, params, rng, steps=300, batch_size=256
        )
        x = inst.distribution_initial.sample(512, rng)[:, :2]
        from pde_inverse.ops import autodiff as ad

        V = lambda xi: net.apply(pre, xi)[0]
        target = 0.1 * ad.batched_grad(inst.V_true_fn, x)
        err = jnp.mean(jnp.sum((ad.batched_grad(V, x) - target) ** 2, -1))
        V0 = lambda xi: net.apply(params, xi)[0]
        err0 = jnp.mean(jnp.sum((ad.batched_grad(V0, x) - target) ** 2, -1))
        assert float(err) < 0.2 * float(err0)


class TestPlotting:
    def test_plots_write_files(self, rng, tmp_path):
        from pde_inverse.utils import plotting

        z = np.asarray(jax.random.normal(rng, (5, 64, 4)))
        gif = plotting.plot_velocity_animation(z, str(tmp_path / "vel.gif"))
        assert os.path.getsize(gif) > 0
        png = plotting.plot_scatter(z[0], str(tmp_path / "scatter.png"))
        assert os.path.getsize(png) > 0
        heat = plotting.plot_density_heatmap(z[0], str(tmp_path / "heat.png"))
        assert os.path.getsize(heat) > 0

        from pde_inverse.ops.gaussian import gaussian_logdensity

        fn = lambda t, xy: gaussian_logdensity(xy, jnp.zeros(2), jnp.eye(2))
        panel = plotting.plot_density_trajectory(
            fn, str(tmp_path / "traj.png"), n_time_points=3, grid_size=24
        )
        assert os.path.getsize(panel) > 0


class TestPlotFnAndDataUtils:
    def test_method_plot_fn(self, rng, tmp_path):
        from pde_inverse.config import Config, apply_overrides
        from pde_inverse.methods import ConsistencyBased
        from pde_inverse.problems import KineticFokkerPlanckOU

        cfg = apply_overrides(
            Config(),
            ["pde_instance.name=Kinetic-Fokker-Planck", "pde_instance.domain_dim=2"],
        )
        inst = KineticFokkerPlanckOU(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        net, params = method.create_model_fn()
        out = method.plot_fn(net.apply, params, rng, str(tmp_path / "f.png"))
        assert os.path.getsize(out) > 0

    def test_infinite_batches(self, rng):
        from pde_inverse.distributions import Gaussian, Uniform
        from pde_inverse.utils.data import infinite_batches

        it = infinite_batches(
            rng,
            Uniform.create(jnp.float32(0.0), jnp.float32(1.0)),
            Gaussian.create(jnp.zeros(2), jnp.eye(2)),
            batch_size=16,
        )
        b1, b2 = next(it), next(it)
        assert b1["space"].shape == (16, 2) and b1["time"].shape == (16,)
        assert not np.allclose(b1["space"], b2["space"])

    def test_save_config(self, tmp_path):
        from pde_inverse.config import Config
        from pde_inverse.utils.data import save_config

        p = save_config(Config(), str(tmp_path))
        import json

        data = json.load(open(p))
        assert data["train"]["number_of_iterations"] == 80000

    def test_volume_nd_ball(self):
        from pde_inverse.ops.autodiff import volume_nd_ball

        np.testing.assert_allclose(volume_nd_ball(2), np.pi, rtol=1e-6)
        np.testing.assert_allclose(volume_nd_ball(3), 4 / 3 * np.pi, rtol=1e-6)


class TestOfflineExactOUFamily:
    """Offline datasets for the OU-family instances (exact Gaussian law) and
    the offline KMV path they enable — capability cells absent from the
    reference AND from round 1."""

    def _kou_cfg(self, name="Kinetic-Fokker-Planck", extra=()):
        return apply_overrides(
            Config(),
            [
                f"pde_instance.name={name}",
                "pde_instance.domain_dim=2",
                "pde_instance.sample_mode=offline",
                "pde_instance.sample_initial_size=128",
                "pde_instance.sample_terminal_size=128",
                "pde_instance.sample_0T_size=400",
                "pde_instance.n_steps_0T=10",
                "pde_instance.total_evolving_time=1",
            ]
            + list(extra),
        )

    def test_kou_offline_dataset_is_exact(self, rng):
        """Whitened squared residuals of every (trajectory, stamp) draw
        against the oracle law at its own stamp must average ~D (chi^2
        moment check of exactness)."""
        inst = KineticFokkerPlanckOU(self._kou_cfg(), rng)
        ds = inst.dataset
        assert ds["0T"].shape == (400, 10, 4)
        assert ds["tau_0T"].shape == (400, 10)
        taus = np.asarray(ds["tau_0T"])
        assert (np.diff(taus, axis=1) > 0).all()
        # trajectory j uses shifted grid j % G
        G = KineticFokkerPlanckOU._N_SHIFT_GROUPS
        np.testing.assert_allclose(taus[0], taus[G % 400], rtol=1e-6)

        flat_t = jnp.asarray(taus.reshape(-1))
        flat_z = ds["0T"].reshape(-1, 4)
        means, covs = inst.oracle.moments_grid(flat_t)
        resid = flat_z - means
        white = jnp.einsum(
            "ni,ni->n", resid, jnp.linalg.solve(covs, resid[..., None])[..., 0]
        )
        chi2_mean = float(jnp.mean(white))  # E = D = 4
        assert abs(chi2_mean - 4.0) < 0.15, chi2_mean

    def test_kmv_offline_value_and_grad(self, rng):
        from pde_inverse.problems import KineticMcKeanVlasovQuadratic

        cfg = self._kou_cfg(name="Kinetic-McKean-Vlasov")
        inst = KineticMcKeanVlasovQuadratic(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        net, params = method.create_model_fn()
        out = jax.jit(
            lambda p, k, ds: method.value_and_grad_fn(net.apply, p, k, dataset=ds)
        )(params, rng, inst.dataset)
        assert np.isfinite(float(out["loss"]))
        assert np.isfinite(float(out["loss ground truth"]))
        for leaf in jax.tree_util.tree_leaves(out["grad"]):
            assert np.isfinite(np.asarray(leaf)).all()

    def test_kmv_offline_weights_match_shared_grid(self, rng):
        """When every trajectory sits on the SAME grid, the per-sample
        weight path must agree with the shared-grid path."""
        from pde_inverse.losses.kinetic_mckean_vlasov import (
            compute_weights,
            compute_weights_per_sample,
        )
        from pde_inverse.problems import KineticMcKeanVlasovQuadratic

        cfg = self._kou_cfg(name="Kinetic-McKean-Vlasov")
        inst = KineticMcKeanVlasovQuadratic(cfg, rng)
        n, nt = 8, 5
        taus = jnp.linspace(0.1, 0.9, nt)
        x = jax.random.normal(rng, (n, nt, 2))
        w_shared = compute_weights(inst, taus, x)
        w_per = compute_weights_per_sample(
            inst, jnp.broadcast_to(taus, (n, nt)), x
        )
        np.testing.assert_allclose(
            np.asarray(w_shared), np.asarray(w_per), rtol=2e-4, atol=2e-4
        )

    def test_kmv_offline_grouped_weights_match_per_sample(self, rng):
        """compute_weights_grouped (one oracle eval per (group, stamp))
        must equal the per-element path on the same points/stamps."""
        from pde_inverse.losses.kinetic_mckean_vlasov import (
            compute_weights_grouped,
            compute_weights_per_sample,
        )
        from pde_inverse.problems import KineticMcKeanVlasovQuadratic

        cfg = self._kou_cfg(name="Kinetic-McKean-Vlasov")
        inst = KineticMcKeanVlasovQuadratic(cfg, rng)
        G, k, nt = 3, 4, 5
        taus_g = jnp.sort(jax.random.uniform(rng, (G, nt)), axis=1) + 0.05
        x = jax.random.normal(jax.random.fold_in(rng, 1), (G, k, nt, 2))
        w_g = compute_weights_grouped(inst, taus_g, x)
        w_per = compute_weights_per_sample(
            inst,
            jnp.broadcast_to(taus_g[:, None], (G, k, nt)).reshape(-1, nt),
            x.reshape(-1, nt, 2),
        )
        np.testing.assert_allclose(
            np.asarray(w_g.reshape(-1, nt)), np.asarray(w_per),
            rtol=2e-4, atol=2e-4,
        )

    def test_kmv_offline_grouped_policy_and_loss(self, rng):
        """With sample_0T_size divisible by the G=64 shift groups, the
        offline policy surfaces 'tau_0T_groups' with group-major rows, and
        the grouped loss equals the per-trajectory path on the same data."""
        from pde_inverse.losses import kinetic_mckean_vlasov as kmv_loss
        from pde_inverse.problems import KineticMcKeanVlasovQuadratic

        cfg = self._kou_cfg(
            name="Kinetic-McKean-Vlasov",
            extra=["pde_instance.sample_0T_size=640"],
        )
        inst = KineticMcKeanVlasovQuadratic(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        net, params = method.create_model_fn()
        data = method.sample_data(rng, dataset=inst.dataset)
        assert "tau_0T_groups" in data
        G, nt = data["tau_0T_groups"].shape
        assert G == 64
        n_rows = data["0T"].shape[0] // nt

        loss_g, gap_g = kmv_loss.make_loss_fn(net.apply, data, inst)(params)

        # equivalent per-trajectory stamps: row r belongs to group r // k
        k = n_rows // G
        per_traj = jnp.broadcast_to(
            data["tau_0T_groups"][:, None], (G, k, nt)
        ).reshape(-1, nt)
        data_pt = {key: v for key, v in data.items() if key != "tau_0T_groups"}
        data_pt["tau_0T_per_traj"] = per_traj
        loss_p, gap_p = kmv_loss.make_loss_fn(net.apply, data_pt, inst)(params)
        np.testing.assert_allclose(
            float(loss_g), float(loss_p), rtol=2e-5, atol=1e-6
        )
        np.testing.assert_allclose(
            float(gap_g), float(gap_p), rtol=2e-5, atol=1e-7
        )

    def test_offline_streaming_trainer(self, rng, tmp_path):
        """Host-streaming offline mode: the trajectory store stays a host
        memmap (never jnp.asarray'd), the trainer gathers per-chunk batches
        host-side, and training steps run with finite losses.  This is the
        '>device-memory store' training path."""
        import numpy as np

        from pde_inverse.problems import KineticFokkerPlanckGMM
        from pde_inverse.training.trainer import Trainer

        store = str(tmp_path / "stream_store")
        cfg = _offline_cfg(
            [
                f"pde_instance.dataset_path={store}",
                "pde_instance.offline_streaming=True",
                "solver.train.offline_traj_batch=16",
                "train.number_of_iterations=6",
                "train.steps_per_chunk=3",
                "test.frequency=0",
                "plot.enable=False",
            ]
        )
        inst = KineticFokkerPlanckGMM(cfg, rng)
        # the store stayed on host: 0T absent from the device dataset
        assert "0T" not in inst.dataset
        assert isinstance(inst.dataset_stream["0T"], np.memmap)

        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        net, params = method.create_model_fn()
        trainer = Trainer(
            cfg=cfg, method=method, rng=rng, forward_fn=net.apply, params=params
        )
        out = trainer.fit()
        assert all(
            np.isfinite(np.asarray(leaf)).all()
            for leaf in jax.tree_util.tree_leaves(out)
        )

    def test_stream_gather_is_deterministic(self, rng, tmp_path):
        """The host-side gather must be a pure function of the chunk keys
        (resume reproducibility depends on it)."""
        import numpy as np

        from pde_inverse.problems import KineticFokkerPlanckGMM

        store = str(tmp_path / "det_store")
        cfg = _offline_cfg(
            [
                f"pde_instance.dataset_path={store}",
                "pde_instance.offline_streaming=True",
                "solver.train.offline_traj_batch=8",
            ]
        )
        inst = KineticFokkerPlanckGMM(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        rngs = jax.random.split(rng, 4)
        a = method.gather_stream_chunk(inst.dataset_stream, rngs)
        b = method.gather_stream_chunk(inst.dataset_stream, rngs)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        c = method.gather_stream_chunk(
            inst.dataset_stream, jax.random.split(jax.random.fold_in(rng, 9), 4)
        )
        assert not np.array_equal(a["0T"], c["0T"])

    def test_kmv_nonparametric_online_step(self, rng):
        """Non-parametric interaction kernel (MLP Phi) on KMV: the loss,
        grad, and live test metric must all work — a capability cell the
        reference declares axes for but never runs (its KMV scripts are
        parametric-only, scripts/parametric/KMV/*)."""
        cfg = apply_overrides(
            Config(),
            [
                "pde_instance.name=Kinetic-McKean-Vlasov",
                "pde_instance.domain_dim=2",
                "pde_instance.total_evolving_time=1",
                "estimation_mode=non-parametric",
                "neural_network.hidden_dim=16",
                "neural_network.layers=2",
                "neural_network.feature_dim=32",
                "solver.train.sample_mode=grid_time",
                "solver.train.n_time_stamps=2",
                "solver.train.sample_per_time=32",
                "solver.train.batch_size_init=0",
                "solver.train.batch_size_terminal=0",
            ],
        )
        from pde_inverse.problems import KineticMcKeanVlasovQuadratic

        inst = KineticMcKeanVlasovQuadratic(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        net, params = method.create_model_fn()
        out = jax.jit(lambda p, k: method.value_and_grad_fn(net.apply, p, k))(
            params, rng
        )
        assert np.isfinite(float(out["loss"]))
        for leaf in jax.tree_util.tree_leaves(out["grad"]):
            assert np.isfinite(np.asarray(leaf)).all()
        metrics = method.test_fn(net.apply, params, jax.random.fold_in(rng, 3))
        (rel,) = metrics.values()
        assert np.isfinite(float(rel))

    def test_kmv_missing_stamps_raises(self, rng):
        from pde_inverse.losses import kinetic_mckean_vlasov as kmv_loss
        from pde_inverse.problems import KineticMcKeanVlasovQuadratic

        cfg = self._kou_cfg(name="Kinetic-McKean-Vlasov")
        inst = KineticMcKeanVlasovQuadratic(cfg, rng)
        data = {"0T": jnp.zeros((20, 4))}
        with pytest.raises(ValueError, match="time stamps"):
            kmv_loss.make_loss_fn(lambda p, x: x.sum(), data, inst)


class TestDatasetPersistence:
    def test_save_and_reload(self, rng, tmp_path):
        path = str(tmp_path / "ds.npz")
        cfg = _offline_cfg([f"pde_instance.dataset_path={path}"])
        inst1 = KineticFokkerPlanckGMM(cfg, rng)
        assert os.path.exists(path)
        # second instance loads the SAME dataset even with a different rng
        inst2 = KineticFokkerPlanckGMM(cfg, jax.random.fold_in(rng, 1))
        np.testing.assert_allclose(inst1.dataset["0T"], inst2.dataset["0T"])
        np.testing.assert_allclose(
            inst1.dataset["initial"], inst2.dataset["initial"]
        )

    def test_memmap_store_roundtrip(self, rng, tmp_path):
        """Directory (non-.npz) paths use the sharded raw array store: the
        store generates in shards, reloads as memmap views, and a second
        instance maps the SAME data (scale-robust persistence, round 1
        missing #5)."""
        from pde_inverse.utils.data import load_array_store

        path = str(tmp_path / "store")
        # shard the generation: initial=256 with a tiny element budget
        cfg = _offline_cfg([f"pde_instance.dataset_path={path}"])
        inst1 = KineticFokkerPlanckGMM(cfg, rng)
        assert os.path.exists(os.path.join(path, "manifest.json"))
        assert os.path.exists(os.path.join(path, "0T.bin"))

        # raw store reloads as read-only memmaps without a host copy
        store = load_array_store(path)
        assert isinstance(store["0T"], np.memmap)
        assert store["0T"].shape == (64, 25, 4)
        np.testing.assert_allclose(np.asarray(inst1.dataset["0T"]), store["0T"])

        inst2 = KineticFokkerPlanckGMM(cfg, jax.random.fold_in(rng, 1))
        np.testing.assert_allclose(
            np.asarray(inst1.dataset["initial"]), np.asarray(inst2.dataset["initial"])
        )
        # distributions of the store are sane (simulated particles moved)
        assert float(np.abs(np.asarray(store["terminal"])).mean()) > 0

    def test_sharded_generation_matches_shapes(self, rng, tmp_path):
        """Force multiple shards by shrinking the element budget; shapes and
        finiteness must survive the shard boundaries."""
        path = str(tmp_path / "store_sharded")
        cfg = _offline_cfg([f"pde_instance.dataset_path={path}"])

        class Tiny(KineticFokkerPlanckGMM):
            _STORE_SHARD_ELEMENTS = 1000  # initial: 256x4 -> 2 shards; 0T: many

        inst = Tiny(cfg, rng)
        ds = inst.dataset
        assert ds["initial"].shape == (256, 4)
        assert ds["terminal"].shape == (128, 4)
        assert ds["0T"].shape == (64, 25, 4)
        assert ds["tau_0T"].shape == (64, 25)
        for v in ds.values():
            assert np.isfinite(np.asarray(v)).all()
        # taus are strictly increasing within each trajectory
        taus = np.asarray(ds["tau_0T"])
        assert (np.diff(taus, axis=1) > 0).all()
