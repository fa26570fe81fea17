"""Hypothesis-network unit tests (PotentialMLP / ResNetPotential / factory).

Parity target: V_hypothesis (reference core/model.py:32-62) — scalar,
nonnegative potential; plus rebuild-only capabilities: configurable feature
width, ResNet variant (the reference raises, core/model.py:116-118),
bfloat16 hidden path, and the random-Fourier front end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_inverse.config import Config, apply_overrides
from pde_inverse.models.factory import get_model
from pde_inverse.models.mlp import PotentialMLP, ResNetPotential


class TestPotentialMLP:
    def _apply(self, net, d=3, n=17):
        x = jax.random.normal(jax.random.PRNGKey(0), (n, d))
        params = net.init(jax.random.PRNGKey(1), x[0])
        return params, net.apply(params, x), x

    def test_scalar_nonnegative_batched(self):
        net = PotentialMLP(hidden_dims=(8, 8), feature_dim=16)
        _, v, _ = self._apply(net)
        assert v.shape == (17,)
        assert (np.asarray(v) >= 0).all()

    def test_single_point_shape(self):
        net = PotentialMLP(hidden_dims=(8,), feature_dim=16)
        params = net.init(jax.random.PRNGKey(1), jnp.zeros(3))
        out = net.apply(params, jnp.ones(3))
        assert out.shape == (1,)

    def test_fourier_front_end(self):
        net = PotentialMLP(
            hidden_dims=(8, 8), feature_dim=16, fourier_features=12, fourier_scale=0.7
        )
        params, v, x = self._apply(net)
        assert v.shape == (17,)
        assert params["params"]["fourier_B"].shape == (3, 12)
        # gradient field exists and is finite
        g = jax.vmap(jax.grad(lambda xi: net.apply(params, xi)[0]))(x)
        assert np.isfinite(np.asarray(g)).all()
        # B initialization spread follows fourier_scale
        B = np.asarray(params["params"]["fourier_B"])
        assert 0.3 < B.std() < 1.2

    def test_quadratic_head_far_field(self):
        """With the quadratic skip term the gradient grows linearly far
        from the origin instead of saturating to zero (the bounded-feature
        head alone vanishes there)."""
        net_plain = PotentialMLP(hidden_dims=(8,), feature_dim=8)
        net_quad = PotentialMLP(hidden_dims=(8,), feature_dim=8, quadratic_head=True)
        x_far = 50.0 * jnp.ones((4, 3))
        for net, expect_flat in [(net_plain, True), (net_quad, False)]:
            params = net.init(jax.random.PRNGKey(1), x_far[0])
            g = jax.vmap(jax.grad(lambda xi: net.apply(params, xi)[0]))(x_far)
            gnorm = float(jnp.linalg.norm(g[0]))
            if expect_flat:
                assert gnorm < 1.0, gnorm  # tanh features saturate
            else:
                assert gnorm > 1.0, gnorm  # quadratic term keeps growing

    def test_bfloat16_hidden_path(self):
        net = PotentialMLP(hidden_dims=(8, 8), feature_dim=16, dtype=jnp.bfloat16)
        params, v, _ = self._apply(net)
        assert v.dtype == jnp.float32  # output reduction stays f32
        # params stay f32 for optimizer precision
        for leaf in jax.tree_util.tree_leaves(params):
            assert leaf.dtype == jnp.float32


class TestResNetPotential:
    def test_scalar_nonnegative(self):
        net = ResNetPotential(hidden_dim=8, n_blocks=2, feature_dim=16)
        x = jax.random.normal(jax.random.PRNGKey(0), (9, 4))
        params = net.init(jax.random.PRNGKey(1), x[0])
        v = net.apply(params, x)
        assert v.shape == (9,)
        assert (np.asarray(v) >= 0).all()


class TestFactory:
    def test_nonparametric_fourier_dispatch(self):
        cfg = apply_overrides(
            Config(),
            [
                "estimation_mode=non-parametric",
                "neural_network.fourier_features=32",
                "neural_network.fourier_scale=1.5",
            ],
        )
        net = get_model(cfg)
        assert isinstance(net, PotentialMLP)
        assert net.fourier_features == 32
        assert net.fourier_scale == 1.5

    def test_resnet_dispatch(self):
        cfg = apply_overrides(
            Config(),
            ["estimation_mode=non-parametric", "neural_network.n_resblocks=3"],
        )
        net = get_model(cfg)
        assert isinstance(net, ResNetPotential)
        assert net.n_blocks == 3

    def test_bilinear_debug_dispatch_and_exact_quadratic(self):
        """bilinear-debug (reference core/model.py:63-96) can represent an
        exact quadratic form: with W set to Q and c=0, V(x) == x.Qx."""
        from pde_inverse.models.mlp import BilinearDebugPotential

        cfg = apply_overrides(
            Config(),
            ["estimation_mode=non-parametric", "neural_network.model=bilinear-debug"],
        )
        net = get_model(cfg)
        assert isinstance(net, BilinearDebugPotential)
        d, n = 3, 11
        x = jax.random.normal(jax.random.PRNGKey(0), (n, d))
        params = net.init(jax.random.PRNGKey(1), x[0])
        assert net.apply(params, x).shape == (n,)
        assert net.apply(params, x[0]).shape == (1,)
        Q = jnp.array([[2.0, 0.5, 0.0], [0.5, 1.0, 0.0], [0.0, 0.0, 3.0]])
        params = jax.tree_util.tree_map(lambda _: None, params)  # guard reuse
        params = {
            "params": {"Dense_0": {"kernel": Q, "bias": jnp.zeros(d)}}
        }
        v = net.apply(params, x)
        np.testing.assert_allclose(v, jnp.einsum("ni,ij,nj->n", x, Q, x), rtol=1e-6)

    def test_unknown_mode_raises(self):
        cfg = apply_overrides(Config(), ["estimation_mode=banana"])
        with pytest.raises(ValueError, match="estimation_mode"):
            get_model(cfg)


# --- plain-JAX modules (models/base.py) --------------------------------------

from pde_inverse.density import flows  # noqa: E402
from pde_inverse.models import fourier_kernel, parametric  # noqa: E402
from pde_inverse.models.mlp import BilinearDebugPotential  # noqa: E402

_X = jnp.linspace(-1, 1, 12).reshape(3, 4)

MODULES = {
    "mlp": (PotentialMLP(hidden_dims=[20] * 3, feature_dim=16), (_X,)),
    "mlp_fourier_quad": (
        PotentialMLP(hidden_dims=[8, 8], feature_dim=16, fourier_features=5,
                     quadratic_head=True, activation="silu"),
        (_X,),
    ),
    "bilinear": (BilinearDebugPotential(), (_X,)),
    "resnet": (ResNetPotential(hidden_dim=8, n_blocks=2, feature_dim=16), (_X,)),
    "quadratic": (parametric.QuadraticFormModel(dim=4), (_X,)),
    "gmm_means": (parametric.GMMMeansModel(dim=4, n_components=3), (_X,)),
    "fourier_kernel": (
        fourier_kernel.FourierKernelModel(dim=4, n_features=16, trainable_frequencies=True),
        (_X,),
    ),
    "flow": (flows.MaskedNormalizingFlow(dim=4, couple_mul=2), (jnp.float32(0.3), _X, False)),
    "realnvp": (
        flows.build_realnvp(lambda z: -0.5 * jnp.sum(z**2, -1), 4, couple_mul=1),
        (jnp.float32(0.7), _X),
    ),
    "mlp_bf16": (PotentialMLP(hidden_dims=[8], feature_dim=8, dtype=jnp.bfloat16), (_X,)),
    "flow_hard_no_time_emb": (
        flows.MaskedNormalizingFlow(dim=4, couple_mul=1, embed_time_dim=0, soft_init=0.0),
        (jnp.float32(0.3), _X, True),
    ),
}

# Fingerprints of init(PRNGKey(3)) and apply, recorded from the Flax linen
# modules these replace: sum over leaves of sum(leaf * (1..size)) and the
# summed outputs.  Equal fingerprints = the same parameter draws.
GOLDEN = {
    "mlp": (2971.913183830786, 31.43116283416748),
    "mlp_fourier_quad": (415.7435263254956, 13.873362421989441),
    "bilinear": (19.547889195382595, 2.7043156176805496),
    "resnet": (35.116440125866575, 19.51258397102356),
    "quadratic": (20.04713436216116, 2.817998558282852),
    "gmm_means": (-12.957733403891325, 0.9069416522979736),
    "fourier_kernel": (-361.37624708906515, 0.5589094087481499),
    "flow": (-3499.89816768506, 1.15747731924057),
    "realnvp": (-989.8848046339754, -4.216374039649963),
    "mlp_bf16": (-84.15882243839587, 17.02893352508545),
    "flow_hard_no_time_emb": (-1482.5648843407253, 0.7656758613884449),
}

TREES = {
    "mlp": {f"Dense_{k}" for k in range(4)},
    "mlp_fourier_quad": {"fourier_B", "Dense_0", "Dense_1", "Dense_2", "quad_A", "quad_b"},
    "bilinear": {"Dense_0"},
    "resnet": {f"Dense_{k}" for k in range(6)},
    "quadratic": {"F"},
    "gmm_means": {"mus"},
    "fourier_kernel": {"omega", "amp_cos", "amp_sin", "quad_A", "quad_b"},
    "flow": {"layers_0", "layers_1", "layers_2", "layers_3", "layers_4", "layers_5", "layers_6", "layers_7"},
    "realnvp": {"flow"},
    "mlp_bf16": {"Dense_0", "Dense_1"},
    "flow_hard_no_time_emb": {"layers_0", "layers_1", "layers_2", "layers_3"},
}


def _fingerprint(tree):
    return sum(
        float(np.sum(np.asarray(l, np.float64) * np.arange(1, l.size + 1).reshape(l.shape)))
        for l in jax.tree_util.tree_leaves(tree)
    )


class TestPlainJaxModules:
    @pytest.mark.parametrize("name", sorted(MODULES))
    def test_tree_names_shapes_dtypes(self, name):
        module, args = MODULES[name]
        variables = module.init(jax.random.PRNGKey(3), *args)
        assert set(variables) == {"params"}
        assert set(variables["params"]) == TREES[name]
        for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
            assert leaf.dtype == jnp.float32, jax.tree_util.keystr(path)
            key = jax.tree_util.keystr(path)
            if key.endswith("['kernel']"):
                assert leaf.ndim == 2
            if key.endswith("['bias']"):
                assert leaf.ndim == 1 and not np.any(np.asarray(leaf))

    @pytest.mark.parametrize("name", sorted(MODULES))
    def test_init_and_apply_match_recorded(self, name):
        module, args = MODULES[name]
        variables = module.init(jax.random.PRNGKey(3), *args)
        out = module.apply(variables, *args)
        want_p, want_out = GOLDEN[name]
        np.testing.assert_allclose(_fingerprint(variables), want_p, rtol=1e-6)
        got_out = sum(float(np.sum(np.asarray(o, np.float64))) for o in jax.tree_util.tree_leaves(out))
        np.testing.assert_allclose(got_out, want_out, rtol=1e-5)

    def test_init_statistics(self):
        """kaiming-normal kernels (std sqrt(2/fan_in)), N(0, scale^2)
        Fourier frequencies, N(0, 0.1^2) quadratic head, zero biases."""
        net = PotentialMLP(hidden_dims=[512], feature_dim=512, fourier_features=2048,
                           fourier_scale=0.5, quadratic_head=True)
        p = net.init(jax.random.PRNGKey(0), jnp.zeros(64))["params"]
        k1 = np.asarray(p["Dense_1"]["kernel"])
        assert abs(k1.std() - np.sqrt(2.0 / 512)) < 0.05 * np.sqrt(2.0 / 512)
        assert abs(k1.mean()) < 3 * np.sqrt(2.0 / 512) / 512
        assert abs(np.asarray(p["fourier_B"]).std() - 0.5) < 0.01
        assert abs(np.asarray(p["quad_A"]).std() - 0.1) < 0.01
        assert not np.any(np.asarray(p["quad_b"]))
        lecun = np.asarray(
            parametric.QuadraticFormModel(dim=256).init(jax.random.PRNGKey(1), jnp.zeros(256))["params"]["F"]["kernel"]
        )
        assert abs(lecun.std() - np.sqrt(1.0 / 256)) < 0.05 * np.sqrt(1.0 / 256)

    def test_potential_mlp_matches_written_formula(self):
        net = PotentialMLP(hidden_dims=[6, 5], feature_dim=4, fourier_features=3, quadratic_head=True)
        p = net.init(jax.random.PRNGKey(5), jnp.zeros(2))["params"]
        x = jax.random.normal(jax.random.PRNGKey(6), (7, 2))
        proj = x @ p["fourier_B"]
        h = jnp.concatenate([x, jnp.cos(proj), jnp.sin(proj)], -1)
        h = jnp.tanh(h @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"])
        h = jnp.tanh(h @ p["Dense_1"]["kernel"] + p["Dense_1"]["bias"])
        h = h @ p["Dense_2"]["kernel"] + p["Dense_2"]["bias"]
        want = jnp.sum(h * h, -1) + 0.5 * jnp.sum((x @ p["quad_A"].T) ** 2, -1) + x @ p["quad_b"]
        np.testing.assert_allclose(net.apply({"params": p}, x), want, rtol=1e-5)
        np.testing.assert_allclose(net.apply({"params": p}, x[0]), want[:1], rtol=1e-5)

    def test_parametric_and_fourier_match_written_formulas(self):
        x = jax.random.normal(jax.random.PRNGKey(7), (5, 3))
        q = parametric.QuadraticFormModel(dim=3)
        p = q.init(jax.random.PRNGKey(0), x)["params"]["F"]
        np.testing.assert_allclose(
            q.apply({"params": {"F": p}}, x),
            jnp.sum(x * (x @ p["kernel"] + p["bias"]), -1), rtol=1e-5,
        )
        fk = fourier_kernel.FourierKernelModel(dim=3, n_features=8)
        pf = fk.init(jax.random.PRNGKey(1), x)["params"]
        ph = x @ pf["omega"].T
        want = (jnp.cos(ph) @ pf["amp_cos"] + jnp.sin(ph) @ pf["amp_sin"]
                + 0.5 * jnp.sum((x @ pf["quad_A"].T) ** 2, -1) + x @ pf["quad_b"])
        np.testing.assert_allclose(fk.apply({"params": pf}, x), want, rtol=1e-5, atol=1e-6)

    def test_flow_is_invertible_with_matching_log_det(self):
        flow = flows.MaskedNormalizingFlow(dim=3, couple_mul=2)
        x = jax.random.normal(jax.random.PRNGKey(2), (6, 3))
        t = jnp.float32(0.4)
        v = flow.init(jax.random.PRNGKey(0), t, x, False)
        v = jax.tree_util.tree_map(lambda a: a + 0.05, v)
        y, ldj_f = flow.apply(v, t, x, False)
        x_back, ldj_r = flow.apply(v, t, y, True)
        np.testing.assert_allclose(x_back, x, atol=1e-5)
        np.testing.assert_allclose(ldj_f, -ldj_r, atol=1e-5)
        assert set(v["params"]["layers_0"]) == {"scaling_factor", "time_emb", "ConditionerMLP_0", "ConditionerMLP_1"}
        assert "time_emb" not in v["params"]["layers_1"]

    @pytest.mark.parametrize(
        "ckpt,module",
        [
            ("r3N/r3N_mlp15k_ckpt", PotentialMLP(hidden_dims=[20] * 8, feature_dim=128)),
            ("r3F/r3F_fk_s0_40k_ckpt", fourier_kernel.FourierKernelModel(dim=2, n_features=512)),
        ],
        ids=["mlp-20x8", "fourier-kernel-512"],
    )
    def test_committed_checkpoint_restores(self, ckpt, module):
        """Checkpoints written by the earlier modules restore into these:
        the same tree, shapes and dtypes, and a finite field."""
        import os

        import orbax.checkpoint as ocp

        path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts", ckpt)
        mgr = ocp.CheckpointManager(path)
        restored = mgr.restore(mgr.latest_step())["params"]
        fresh = module.init(jax.random.PRNGKey(0), jnp.zeros(2))
        assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(fresh)
        for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(fresh)):
            assert a.shape == b.shape and a.dtype == b.dtype
        y = jax.random.normal(jax.random.PRNGKey(1), (16, 2))
        out = module.apply(jax.tree_util.tree_map(jnp.asarray, restored), y)
        assert out.shape == (16,) and bool(jnp.all(jnp.isfinite(out)))
