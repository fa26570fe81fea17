"""Equality gates for the matmul-shaped blockwise pairwise KMV path.

The blockwise reformulation (losses/pairwise_blockwise.py) must reproduce
the generic autodiff chunked reduction — stats, loss, diagnostic gap, AND
parameter gradients — for every PotentialMLP configuration (plain / Fourier
front end / quadratic head), under ref-chunking that does not divide m, and
under 2-D (data, ref) mesh sharding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_inverse.config import BackendConfig, Config, apply_overrides
from pde_inverse.losses import kinetic_mckean_vlasov as kmv_loss
from pde_inverse.losses import pairwise_blockwise as bw
from pde_inverse.models.mlp import PotentialMLP
from pde_inverse.parallel.mesh import build_mesh
from pde_inverse.problems import KineticMcKeanVlasovQuadratic


@pytest.fixture
def rng():
    return jax.random.PRNGKey(7)


def _cfg(dim=2, *extra):
    return apply_overrides(
        Config(),
        [
            "pde_instance.name=Kinetic-McKean-Vlasov",
            f"pde_instance.domain_dim={dim}",
            "pde_instance.total_evolving_time=1",
            "estimation_mode=non-parametric",
            "solver.train.n_time_stamps=2",
            "solver.train.sample_per_time=12",
            "solver.train.sample_mode=grid_time",
            "solver.train.batch_size_init=8",
            "solver.train.batch_size_terminal=8",
            "neural_network.hidden_dim=16",
            "neural_network.layers=2",
            "neural_network.feature_dim=8",
            *extra,
        ],
    )


def _setup(rng, n=14, n_time=3, dim=2, hidden=(16, 16), **mlp_kwargs):
    inst = KineticMcKeanVlasovQuadratic(_cfg(dim), rng)
    net = PotentialMLP(hidden_dims=list(hidden), feature_dim=8, **mlp_kwargs)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros(dim))
    data = {
        "0T": inst.sample_ground_truth(rng, (n_time, n)),
        "tau_0T": inst.get_time_sample_ground_truth(rng, (n_time, n)),
    }
    return inst, net, params, data


MLP_VARIANTS = {
    "plain": {},
    "fourier": {"fourier_features": 6, "fourier_scale": 0.7},
    "quad_head": {"quadratic_head": True},
    "fourier+quad": {"fourier_features": 4, "quadratic_head": True},
    "silu": {"activation": "silu"},
    "softplus": {"activation": "softplus"},
    "gelu": {"activation": "gelu"},
    "tanh-depth1": {"hidden": (16,)},
    "tanh-depth3": {"hidden": (16, 12, 16)},
    "silu-depth3": {"activation": "silu", "hidden": (12, 12, 12)},
    "softplus-depth1": {"activation": "softplus", "hidden": (20,)},
}


class TestBlockwiseStats:
    @pytest.mark.parametrize("variant", sorted(MLP_VARIANTS))
    def test_stats_match_generic(self, rng, variant):
        inst, net, params, data = _setup(rng, **MLP_VARIANTS[variant])
        x, v = jnp.split(data["0T"], 2, -1)
        nt = data["tau_0T"].shape[0]
        d = x.shape[-1]
        x = x.reshape(-1, nt, d)
        v = v.reshape(-1, nt, d)

        Phi = lambda xi: net.apply(params, xi)[0]
        from pde_inverse.ops import autodiff as ad

        generic = kmv_loss._pairwise_stats(
            lambda _p, diff, vf: {
                "nabla": ad.batched_grad(Phi, diff),
                "hess": ad.batched_hvp_quadform(Phi, diff, vf),
                "value": ad.batched_value(Phi, diff),
            },
            x, v, x, chunk=5,
        )
        block = bw.mlp_pairwise_stats(net, params, x, v, x, rows_per_chunk=200)
        for k in ("nabla", "hess", "value"):
            np.testing.assert_allclose(
                block[k], generic[k], rtol=2e-4, atol=1e-5, err_msg=k
            )

    def test_chunking_invariance(self, rng):
        """Row budgets that do / don't make the chunk divide m must agree."""
        inst, net, params, data = _setup(rng, n=11, **MLP_VARIANTS["fourier"])
        x, v = jnp.split(data["0T"], 2, -1)
        nt = data["tau_0T"].shape[0]
        x = x.reshape(-1, nt, x.shape[-1])
        v = v.reshape(-1, nt, v.shape[-1])
        full = bw.mlp_pairwise_stats(net, params, x, v, x, rows_per_chunk=10**9)
        for rows in (40, 100, 170):
            part = bw.mlp_pairwise_stats(net, params, x, v, x, rows_per_chunk=rows)
            for k in ("nabla", "hess", "value"):
                np.testing.assert_allclose(
                    part[k], full[k], rtol=2e-5, atol=1e-6, err_msg=f"{k}@{rows}"
                )


class TestBlockwiseLoss:
    @pytest.mark.parametrize("variant", ["plain", "fourier+quad", "silu", "softplus-depth1"])
    def test_loss_and_grad_match_generic(self, rng, variant):
        inst, net, params, data = _setup(rng, **MLP_VARIANTS[variant])
        out_gen = kmv_loss.value_and_grad_fn(
            net.apply, params, data, rng, inst
        )
        out_bw = kmv_loss.value_and_grad_fn(
            net.apply, params, data, rng, inst, blockwise_module=net
        )
        np.testing.assert_allclose(out_bw["loss"], out_gen["loss"], rtol=2e-4)
        np.testing.assert_allclose(
            out_bw["loss ground truth"],
            out_gen["loss ground truth"],
            rtol=2e-4,
            atol=1e-6,
        )
        flat_gen = jax.tree_util.tree_leaves(out_gen["grad"])
        flat_bw = jax.tree_util.tree_leaves(out_bw["grad"])
        for a, b in zip(flat_bw, flat_gen):
            np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-5)

    def test_jit_grad_steps(self, rng):
        """The blockwise loss is jittable and optimizes (smoke)."""
        import optax

        inst, net, params, data = _setup(rng, **MLP_VARIANTS["fourier"])
        opt = optax.adam(1e-3)
        state = opt.init(params)

        @jax.jit
        def step(p, s):
            out = kmv_loss.value_and_grad_fn(
                net.apply, p, data, rng, inst, blockwise_module=net,
                blockwise_rows=64,
            )
            up, s = opt.update(out["grad"], s, p)
            return optax.apply_updates(p, up), s, out["loss"]

        losses = []
        for _ in range(5):
            params, state, loss = step(params, state)
            losses.append(float(loss))
        assert np.isfinite(losses).all()


class TestBlockwiseSharded:
    def test_ref_axis_sharding_matches_local(self, rng):
        """2-D (data, ref) mesh: blockwise stats must equal the unsharded
        path bit-for-bit in distribution (tolerance: collective reorder)."""
        inst, net, params, data = _setup(rng, n=16, **MLP_VARIANTS["fourier"])
        x, v = jnp.split(data["0T"], 2, -1)
        nt = data["tau_0T"].shape[0]
        x = x.reshape(-1, nt, x.shape[-1])
        v = v.reshape(-1, nt, v.shape[-1])

        local = bw.mlp_pairwise_stats(net, params, x, v, x, rows_per_chunk=300)
        spec = build_mesh(BackendConfig(data_axis_size=4, ref_axis_size=2))
        sharded = bw.mlp_pairwise_stats(
            net, params, x, v, x, rows_per_chunk=300, mesh_spec=spec
        )
        for k in ("nabla", "hess", "value"):
            np.testing.assert_allclose(
                sharded[k], local[k], rtol=1e-5, atol=1e-6, err_msg=k
            )

    def test_ref_sharding_with_padding(self, rng):
        """m not divisible by the ref axis: padded refs must not contribute."""
        inst, net, params, data = _setup(rng, n=15)
        x, v = jnp.split(data["0T"], 2, -1)
        nt = data["tau_0T"].shape[0]
        x = x.reshape(-1, nt, x.shape[-1])
        v = v.reshape(-1, nt, v.shape[-1])
        local = bw.mlp_pairwise_stats(net, params, x, v, x)
        spec = build_mesh(BackendConfig(data_axis_size=1, ref_axis_size=8))
        sharded = bw.mlp_pairwise_stats(net, params, x, v, x, mesh_spec=spec)
        for k in ("nabla", "hess", "value"):
            np.testing.assert_allclose(
                sharded[k], local[k], rtol=1e-5, atol=1e-6, err_msg=k
            )


class TestMethodDispatch:
    def test_method_uses_blockwise_for_mlp(self, rng, monkeypatch):
        """ConsistencyBased routes non-parametric KMV through the blockwise
        path (and kmv_blockwise=False disables it)."""
        from pde_inverse.methods import ConsistencyBased

        cfg = _cfg()
        inst = KineticMcKeanVlasovQuadratic(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        net, params = method.create_model_fn()
        assert isinstance(net, PotentialMLP)

        calls = {}
        orig = bw.mlp_pairwise_stats

        def spy(*a, **k):
            calls["hit"] = True
            return orig(*a, **k)

        monkeypatch.setattr(bw, "mlp_pairwise_stats", spy)
        method.value_and_grad_fn(net.apply, params, rng)
        assert calls.get("hit")

        calls.clear()
        cfg_off = _cfg(2, "solver.train.kmv_blockwise=False")
        method_off = ConsistencyBased(pde_instance=inst, cfg=cfg_off, rng=rng)
        net2, params2 = method_off.create_model_fn()
        method_off.value_and_grad_fn(net2.apply, params2, rng)
        assert not calls.get("hit")


def _dot_precisions(fn, *args):
    """Precision params of every dot_general in fn's jaxpr (nested too)."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


class TestPairPrecision:
    """The pair reduction pins float32 matmuls (TF32 products measured past
    the loss's tolerance on the card), forward and backward, whatever the
    caller's default precision."""

    @pytest.mark.parametrize("default", [None, "bfloat16", "tensorfloat32"])
    def test_forward_and_backward_dots_are_float32(self, rng, default):
        inst, net, params, data = _setup(rng, n=6, **MLP_VARIANTS["quad_head"])
        x, v = jnp.split(data["0T"], 2, -1)
        nt = data["tau_0T"].shape[0]
        x = x.reshape(-1, nt, x.shape[-1])
        v = v.reshape(-1, nt, v.shape[-1])

        def loss(p):
            s = bw.mlp_pairwise_stats(net, p, x, v, x)
            return jnp.sum(s["hess"]) + jnp.sum(s["nabla"] ** 2)

        hi = jax.lax.Precision.HIGHEST
        with jax.default_matmul_precision(default):
            fwd = _dot_precisions(loss, params)
            bwd = _dot_precisions(jax.grad(loss), params)
        assert fwd and len(bwd) > len(fwd)
        assert all(p == (hi, hi) for p in fwd + bwd), set(fwd + bwd)

    def test_pinned_under_ref_sharding(self, rng):
        inst, net, params, data = _setup(rng, n=8)
        x, v = jnp.split(data["0T"], 2, -1)
        nt = data["tau_0T"].shape[0]
        x = x.reshape(-1, nt, x.shape[-1])
        v = v.reshape(-1, nt, v.shape[-1])
        spec = build_mesh(BackendConfig(data_axis_size=4, ref_axis_size=2))
        hi = jax.lax.Precision.HIGHEST
        with jax.default_matmul_precision("tensorfloat32"):
            precs = _dot_precisions(
                lambda p: bw.mlp_pairwise_stats(net, p, x, v, x, mesh_spec=spec)["hess"], params
            )
        assert precs and all(p == (hi, hi) for p in precs)
