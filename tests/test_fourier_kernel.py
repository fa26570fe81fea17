"""Equality gates for the Fourier-kernel hypothesis and its exact
O((n+m)K) mean-field collapse (models/fourier_kernel.py,
losses/fourier_meanfield.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_inverse.config import Config, apply_overrides
from pde_inverse.losses import fourier_meanfield as fmf
from pde_inverse.losses import kinetic_mckean_vlasov as kmv_loss
from pde_inverse.models.fourier_kernel import FourierKernelModel
from pde_inverse.ops import autodiff as ad
from pde_inverse.problems import KineticMcKeanVlasovQuadratic


@pytest.fixture
def rng():
    return jax.random.PRNGKey(23)


def _cfg(*extra):
    return apply_overrides(
        Config(),
        [
            "pde_instance.name=Kinetic-McKean-Vlasov",
            "pde_instance.domain_dim=2",
            "pde_instance.total_evolving_time=1",
            "estimation_mode=non-parametric",
            "neural_network.model=fourier-kernel",
            "neural_network.fourier_features=16",
            "neural_network.quadratic_head=True",
            "solver.train.sample_mode=grid_time",
            "solver.train.n_time_stamps=2",
            "solver.train.sample_per_time=14",
            "solver.train.batch_size_init=0",
            "solver.train.batch_size_terminal=0",
            *extra,
        ],
    )


def _setup(rng, n=14, nt=2, dim=2, quad=True, K=16, trainable=False):
    inst = KineticMcKeanVlasovQuadratic(_cfg(), rng)
    net = FourierKernelModel(
        dim=dim, n_features=K, quadratic_head=quad,
        trainable_frequencies=trainable,
    )
    params = net.init(jax.random.PRNGKey(0), jnp.zeros(dim))
    # non-degenerate amplitudes for a meaningful gate
    p = dict(params["params"])
    k1, k2 = jax.random.split(rng)
    p["amp_cos"] = 0.3 * jax.random.normal(k1, (K,))
    p["amp_sin"] = 0.3 * jax.random.normal(k2, (K,))
    params = {"params": p}
    data = {
        "0T": inst.sample_ground_truth(rng, (nt, n)),
        "tau_0T": inst.get_time_sample_ground_truth(rng, (nt, n)),
    }
    return inst, net, params, data


class TestFourierMeanfield:
    @pytest.mark.parametrize("quad", [True, False])
    def test_stats_match_bruteforce_pairwise(self, rng, quad):
        """Sufficient-statistics collapse == brute-force O(n^2) pairwise
        means of the SAME Phi."""
        inst, net, params, data = _setup(rng, quad=quad)
        x, v = jnp.split(data["0T"], 2, -1)
        nt = data["tau_0T"].shape[0]
        d = x.shape[-1]
        x = x.reshape(-1, nt, d)
        v = v.reshape(-1, nt, d)

        stats = fmf.meanfield_stats(net, params, x, v, x)

        Phi = lambda y: net.apply(params, y)[0]
        diff = x[None] - x[:, None]  # [m, n, nt, d]
        val = ad.batched_value(Phi, diff).mean(0)
        nab = ad.batched_grad(Phi, diff).mean(0)
        vv = jnp.broadcast_to(v[None], diff.shape)
        hes = ad.batched_hvp_quadform(Phi, diff, vv).mean(0)
        np.testing.assert_allclose(stats["value"], val, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(stats["nabla"], nab, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(stats["hess"], hes, rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("trainable", [False, True])
    def test_loss_and_grad_match_generic(self, rng, trainable):
        """Full KMV loss + parameter gradients: collapse vs the generic
        pairwise reduction on the same FourierKernelModel.  With
        trainable_frequencies=True (the production FK recipe — see
        README's trainable-frequency result) the omega cotangent flows
        through the sufficient statistics C, S as well as the x-phases;
        this gates that the collapsed d(loss)/d(omega) matches the
        brute-force pairwise autodiff, not just the amplitude grads."""
        inst, net, params, data = _setup(rng, trainable=trainable)
        out_gen = kmv_loss.value_and_grad_fn(
            net.apply, params, data, rng, inst
        )
        out_fast = kmv_loss.value_and_grad_fn(
            net.apply, params, data, rng, inst, blockwise_module=net
        )
        np.testing.assert_allclose(
            out_fast["loss"], out_gen["loss"], rtol=1e-4
        )
        np.testing.assert_allclose(
            out_fast["loss ground truth"],
            out_gen["loss ground truth"],
            rtol=1e-4,
            atol=1e-6,
        )
        for a, b in zip(
            jax.tree_util.tree_leaves(out_fast["grad"]),
            jax.tree_util.tree_leaves(out_gen["grad"]),
        ):
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-5)
        g_omega = out_fast["grad"]["params"]["omega"]
        if trainable:
            # the gate above is only meaningful if omega actually
            # receives a cotangent in this mode
            assert float(jnp.max(jnp.abs(g_omega))) > 1e-6
        else:
            np.testing.assert_allclose(g_omega, jnp.zeros_like(g_omega))

    def test_fourier_grad_matches_headfree_autodiff(self, rng):
        """fourier_grad == autodiff gradient of a head-FREE twin module
        sharing the same Fourier params (the quadratic head is exactly
        what the semiparametric regularizer excludes)."""
        _, net, params, _ = _setup(rng, quad=True)
        y = jax.random.normal(jax.random.PRNGKey(7), (33, 2)) * 2.0
        got = fmf.fourier_grad(net, params, y)
        twin = FourierKernelModel(
            dim=2, n_features=16, quadratic_head=False
        )
        p = {
            "params": {
                k: params["params"][k]
                for k in ("omega", "amp_cos", "amp_sin")
            }
        }
        want = ad.batched_grad(lambda yi: twin.apply(p, yi)[0], y)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_field_reg_fourier_only_loss_semantics(self, rng):
        """(a) head OFF: the fourier-only penalty equals the standard
        full-field penalty (no head to exclude — identical loss);
        (b) head ON with nonzero quad params: the fourier-only loss
        differs from full-field by exactly lambda * E||grad_quad||^2's
        cross+square contribution (checked as strict inequality of the
        penalties, plus exact reconstruction of the penalty gap)."""
        lam = 0.37
        inst, net_nohead, params0, data = _setup(rng, quad=False)
        common = dict(
            data=data, pde_instance=inst, field_reg=lam,
            field_reg_probes=64,
        )
        l_std = kmv_loss.make_loss_fn(
            net_nohead.apply, blockwise_module=net_nohead, **common
        )
        l_fonly = kmv_loss.make_loss_fn(
            net_nohead.apply, blockwise_module=net_nohead,
            field_reg_fourier_only=True, **common
        )
        np.testing.assert_allclose(
            l_fonly(params0)[0], l_std(params0)[0], rtol=1e-6
        )

        _, net_head, params_h, _ = _setup(rng, quad=True)
        ph = dict(params_h["params"])
        ph["quad_A"] = 0.5 * jnp.eye(2) + 0.1
        ph["quad_b"] = jnp.array([0.2, -0.1])
        params_h = {"params": ph}
        lh_std = kmv_loss.make_loss_fn(
            net_head.apply, blockwise_module=net_head, **common
        )
        lh_fonly = kmv_loss.make_loss_fn(
            net_head.apply, blockwise_module=net_head,
            field_reg_fourier_only=True, **common
        )
        full, fonly = float(lh_std(params_h)[0]), float(lh_fonly(params_h)[0])
        assert full != pytest.approx(fonly), "head should change the penalty"
        # reconstruct: full - fonly = lam * E[||g_f + g_q||^2 - ||g_f||^2]
        x, _ = jnp.split(data["0T"], 2, -1)
        nt = data["tau_0T"].shape[0]
        xf = x.reshape(-1, nt, 2).reshape(-1, 2)
        n_pts = xf.shape[0]
        ii = jnp.arange(min(64, n_pts)) % n_pts
        off = (7919 * nt) % n_pts or nt % n_pts
        probe = xf[ii] - xf[(ii + off) % n_pts]
        g_f = fmf.fourier_grad(net_head, params_h, probe)
        g_full = ad.batched_grad(
            lambda yi: net_head.apply(params_h, yi)[0], probe
        )
        gap_want = lam * float(
            jnp.mean(jnp.sum(g_full**2, -1) - jnp.sum(g_f**2, -1))
        )
        np.testing.assert_allclose(full - fonly, gap_want, rtol=1e-4)

    def test_field_reg_probe_scale_ladder(self, rng):
        """kmv_field_reg_probe_scale: (a) scale=1 is exactly the default
        probe construction; (b) scale>1 multiplies probe i by
        scale**(i/(P-1)) — reconstructed exactly as the penalty gap vs the
        unregularized loss (fourier-only scope, the intended pairing)."""
        lam, n_probe, scale = 0.37, 64, 3.0
        inst, net, params, data = _setup(rng, quad=True)
        common = dict(
            data=data, pde_instance=inst, blockwise_module=net,
            field_reg_fourier_only=True,
        )
        l_base = kmv_loss.make_loss_fn(net.apply, **common)
        l_s1 = kmv_loss.make_loss_fn(
            net.apply, field_reg=lam, field_reg_probes=n_probe,
            field_reg_probe_scale=1.0, **common
        )
        l_def = kmv_loss.make_loss_fn(
            net.apply, field_reg=lam, field_reg_probes=n_probe, **common
        )
        np.testing.assert_allclose(
            l_s1(params)[0], l_def(params)[0], rtol=1e-6
        )

        l_s3 = kmv_loss.make_loss_fn(
            net.apply, field_reg=lam, field_reg_probes=n_probe,
            field_reg_probe_scale=scale, **common
        )
        got_penalty = float(l_s3(params)[0]) - float(l_base(params)[0])
        # independent reconstruction of the widened probe cloud
        x, _ = jnp.split(data["0T"], 2, -1)
        nt = data["tau_0T"].shape[0]
        xf = x.reshape(-1, nt, 2).reshape(-1, 2)
        n_pts = xf.shape[0]
        n_p = min(n_probe, n_pts)
        ii = jnp.arange(n_p) % n_pts
        off = (7919 * nt) % n_pts or nt % n_pts
        probe = xf[ii] - xf[(ii + off) % n_pts]
        ladder = scale ** (jnp.arange(n_p, dtype=jnp.float32) / (n_p - 1))
        probe = probe * ladder[:, None]
        g_f = fmf.fourier_grad(net, params, probe)
        want = lam * float(jnp.mean(jnp.sum(g_f**2, -1)))
        np.testing.assert_allclose(got_penalty, want, rtol=1e-4, atol=1e-8)
        assert not np.isclose(
            float(l_s3(params)[0]), float(l_s1(params)[0])
        ), "widened probes must change the penalty"

    def test_method_dispatch_and_training_smoke(self, rng):
        """ConsistencyBased + factory route neural_network.model=
        fourier-kernel through the collapse; a short jitted optimization
        reduces the ground-truth gap."""
        import optax

        from pde_inverse.methods import ConsistencyBased

        cfg = _cfg()
        inst = KineticMcKeanVlasovQuadratic(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        net, params = method.create_model_fn()
        assert isinstance(net, FourierKernelModel)

        calls = {}
        orig = fmf.meanfield_stats

        def spy(*a, **k):
            calls["hit"] = True
            return orig(*a, **k)

        fmf.meanfield_stats = spy
        try:
            out = method.value_and_grad_fn(net.apply, params, rng)
        finally:
            fmf.meanfield_stats = orig
        assert calls.get("hit")
        assert np.isfinite(float(out["loss"]))

        opt = optax.adam(3e-2)
        state = opt.init(params)

        @jax.jit
        def step(p, s, k):
            out = method.value_and_grad_fn(net.apply, p, k)
            up, s = opt.update(out["grad"], s, p)
            return optax.apply_updates(p, up), s, out["loss ground truth"]

        gap0 = None
        p = params
        for i in range(60):
            p, state, gap = step(p, state, jax.random.fold_in(rng, i))
            if gap0 is None:
                gap0 = float(gap)
        assert float(gap) < 0.5 * gap0, (gap0, float(gap))


class TestMultiscaleInit:
    def test_multiscale_spans_scales(self, rng):
        """freq_init=multiscale draws per-feature stddevs log-uniform in
        [scale/4, 4*scale]: the frequency-row norms must span roughly that
        range, where the normal init concentrates at one scale."""
        def row_norms(init):
            m = FourierKernelModel(
                dim=2, n_features=256, freq_scale=0.5, quadratic_head=False,
                freq_init=init,
            )
            p = m.init(rng, jnp.zeros((1, 2)))
            return np.linalg.norm(np.asarray(p["params"]["omega"]), axis=-1)

        ms, normal = row_norms("multiscale"), row_norms("normal")
        q = lambda a: np.quantile(a, [0.1, 0.9])
        lo_m, hi_m = q(ms)
        lo_n, hi_n = q(normal)
        assert hi_m / lo_m > 2.5 * (hi_n / lo_n), (hi_m / lo_m, hi_n / lo_n)
        # and the collapse path still trains through it
        cfg = _cfg("neural_network.fourier_init=multiscale")
        from pde_inverse.methods import ConsistencyBased

        inst = KineticMcKeanVlasovQuadratic(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        net, params = method.create_model_fn()
        out = method.value_and_grad_fn(net.apply, params, rng)
        assert np.isfinite(float(out["loss"]))

    def test_unknown_init_rejected(self, rng):
        m = FourierKernelModel(dim=2, n_features=8, freq_init="typo")
        with pytest.raises(ValueError, match="freq_init"):
            m.init(rng, jnp.zeros((1, 2)))
