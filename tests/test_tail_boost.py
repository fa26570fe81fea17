"""Tail-boost importance sampling (pde_instance.init_broaden).

The online SDE batches are drawn with the initial POSITION marginal
broadened to N(m, s^2 P_x0) and exact per-trajectory importance weights
w = p0/q0 attached, so every weak-form expectation stays unbiased for the
true path law while the sampler covers the initial-law tail ~s^2 x more
densely.  Reference analogue: none (the reference samples the true law
only, example_problems/kinetic_fokker_planck_example_GMM.py:104-133).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_inverse.config import Config, apply_overrides
from pde_inverse.methods import ConsistencyBased
from pde_inverse.problems import KineticFokkerPlanckGMM


def make_cfg(extra=()):
    return apply_overrides(
        Config(),
        [
            "pde_instance.name=Kinetic-Fokker-Planck",
            "pde_instance.potential=GMM",
            "pde_instance.domain_dim=2",
            "pde_instance.sample_mode=online",
            "pde_instance.n_steps=6",
            "solver.train.batch_size_0T=32",
            *extra,
        ],
    )


@pytest.fixture
def rng():
    return jax.random.PRNGKey(7)


class TestWeights:
    def test_bounded_and_unit_mean(self, rng):
        """w = p0/q0 is bounded by s^dim (attained at the mean) and has
        E_q[w] = 1: the empirical mean over 60k draws must sit within a
        few sigma of 1 (var(w) is finite and known for Gaussian p, q)."""
        s = 1.5
        cfg = make_cfg([f"pde_instance.init_broaden={s}"])
        inst = KineticFokkerPlanckGMM(cfg, rng)
        q = inst._broadened_initial()
        z = q.sample(60_000, jax.random.fold_in(rng, 1))
        w = np.asarray(jnp.exp(inst._init_log_weight(q, z)))
        bound = s**inst.dim
        assert w.max() <= bound * (1 + 1e-5)
        assert abs(w.mean() - 1.0) < 0.02
        # the bound is attained where x = mean
        z0 = inst.distribution_initial.mean[None, :]
        w0 = float(jnp.exp(inst._init_log_weight(q, z0))[0])
        np.testing.assert_allclose(w0, bound, rtol=1e-5)

    def test_weighted_expectation_is_unbiased(self, rng):
        """E_q[w f] = E_p[f] for f(z) = ||z||^2, whose exact value is
        trace(P_0) = (4 + 0.1) * dim."""
        s = 1.5
        cfg = make_cfg([f"pde_instance.init_broaden={s}"])
        inst = KineticFokkerPlanckGMM(cfg, rng)
        q = inst._broadened_initial()
        z = q.sample(400_000, jax.random.fold_in(rng, 2))
        w = jnp.exp(inst._init_log_weight(q, z))
        est = float(jnp.mean(w * jnp.sum(z**2, -1)))
        exact = 4.1 * inst.dim
        assert abs(est - exact) / exact < 0.02

    def test_velocity_marginal_not_reweighted(self, rng):
        """P_0 is block-diagonal and only the x-block is broadened, so the
        weight must be a function of x alone."""
        s = 2.0
        cfg = make_cfg([f"pde_instance.init_broaden={s}"])
        inst = KineticFokkerPlanckGMM(cfg, rng)
        q = inst._broadened_initial()
        z = q.sample(64, jax.random.fold_in(rng, 3))
        d = inst.dim
        z_flip_v = z.at[:, d:].multiply(-1.0)
        np.testing.assert_allclose(
            np.asarray(inst._init_log_weight(q, z)),
            np.asarray(inst._init_log_weight(q, z_flip_v)),
            rtol=1e-6,
        )


class TestDataPolicy:
    def test_weighted_keys_present_and_aligned(self, rng):
        cfg = make_cfg(["pde_instance.init_broaden=1.5"])
        inst = KineticFokkerPlanckGMM(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        data = jax.jit(method.sample_data)(jax.random.fold_in(rng, 4))
        for key, wkey in [
            ("0T", "w_0T"),
            ("initial", "w_initial"),
            ("terminal", "w_terminal"),
        ]:
            assert wkey in data
            assert data[wkey].shape == (data[key].shape[0],)
        # per-trajectory weights repeat across each trajectory's states
        n_states = data["0T"].shape[0] // cfg.solver.train.batch_size_0T
        w = np.asarray(data["w_0T"]).reshape(
            cfg.solver.train.batch_size_0T, n_states
        )
        np.testing.assert_array_equal(w, np.repeat(w[:, :1], n_states, 1))

    def test_off_by_default(self, rng):
        cfg = make_cfg()
        inst = KineticFokkerPlanckGMM(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        data = jax.jit(method.sample_data)(jax.random.fold_in(rng, 4))
        assert not any(k.startswith("w_") for k in data)

    def test_loss_with_unit_weights_is_identical(self, rng):
        """Adding w = 1 arrays must not change the loss or gradient at all
        (same reductions, weights multiply by one)."""
        from pde_inverse.losses import kinetic_fokker_planck as kfp
        from pde_inverse.models.mlp import PotentialMLP

        cfg = make_cfg()
        inst = KineticFokkerPlanckGMM(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        data = jax.jit(method.sample_data)(jax.random.fold_in(rng, 4))
        net = PotentialMLP(hidden_dims=[16], feature_dim=16)
        params = net.init(rng, jnp.zeros((inst.dim,)))
        forward = net.apply

        weighted = dict(data)
        for key, wkey in [
            ("0T", "w_0T"),
            ("initial", "w_initial"),
            ("terminal", "w_terminal"),
        ]:
            weighted[wkey] = jnp.ones(data[key].shape[0])

        out_plain = kfp.value_and_grad_fn(forward, params, data, rng, inst)
        out_w = kfp.value_and_grad_fn(forward, params, weighted, rng, inst)
        np.testing.assert_array_equal(
            np.asarray(out_plain["loss"]), np.asarray(out_w["loss"])
        )
        for a, b in zip(
            jax.tree_util.tree_leaves(out_plain["grad"]),
            jax.tree_util.tree_leaves(out_w["grad"]),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_weighted_loss_matches_plain_in_expectation(self, rng):
        """The broadened+weighted estimator and the plain estimator target
        the SAME expectations: averaged over many independent batches at
        fixed params, the two loss estimates must agree to within MC noise
        (this is the end-to-end unbiasedness gate)."""
        from functools import partial

        from pde_inverse.models.mlp import PotentialMLP

        cfg_p = make_cfg(["solver.train.batch_size_0T=256"])
        cfg_w = make_cfg(
            ["solver.train.batch_size_0T=256", "pde_instance.init_broaden=1.5"]
        )
        inst_p = KineticFokkerPlanckGMM(cfg_p, rng)
        inst_w = KineticFokkerPlanckGMM(cfg_w, rng)  # same rng: same truth
        net = PotentialMLP(hidden_dims=[16], feature_dim=16)
        params = net.init(rng, jnp.zeros((inst_p.dim,)))
        forward = net.apply

        def mean_loss(method, n=24):
            vg = jax.jit(
                partial(method.value_and_grad_fn, forward, params)
            )
            keys = jax.random.split(jax.random.fold_in(rng, 9), n)
            return np.mean([float(vg(k)["loss"]) for k in keys])

        mp = mean_loss(ConsistencyBased(pde_instance=inst_p, cfg=cfg_p, rng=rng))
        mw = mean_loss(ConsistencyBased(pde_instance=inst_w, cfg=cfg_w, rng=rng))
        # scale tolerance by the loss magnitude; both are ~O(10) here
        assert abs(mp - mw) / max(abs(mp), 1.0) < 0.15


class TestGuards:
    def test_antithetic_is_rejected(self, rng):
        cfg = make_cfg(
            ["pde_instance.init_broaden=1.5", "pde_instance.antithetic=True"]
        )
        with pytest.raises(ValueError, match="antithetic"):
            KineticFokkerPlanckGMM(cfg, rng)

    def test_offline_is_rejected(self, rng):
        cfg = make_cfg(
            ["pde_instance.init_broaden=1.5", "pde_instance.sample_mode=offline"]
        )
        with pytest.raises(ValueError, match="ONLINE"):
            KineticFokkerPlanckGMM(cfg, rng)

    def test_below_one_is_rejected(self, rng):
        cfg = make_cfg(["pde_instance.init_broaden=0.5"])
        with pytest.raises(ValueError, match=">= 1.0"):
            KineticFokkerPlanckGMM(cfg, rng)

    def test_exact_offline_is_rejected(self, rng):
        from pde_inverse.problems import KineticFokkerPlanckOU

        cfg = apply_overrides(
            Config(),
            [
                "pde_instance.name=Kinetic-Fokker-Planck",
                "pde_instance.potential=Quadratic",
                "pde_instance.domain_dim=2",
                "pde_instance.sample_mode=offline",
                "pde_instance.init_broaden=1.5",
            ],
        )
        with pytest.raises(ValueError, match="ONLINE"):
            KineticFokkerPlanckOU(cfg, rng)

    def test_exact_random_time_is_rejected(self, rng):
        """The exact-law weighted sampler needs the grid_time batch
        layout; random-time int batches have no (sample, stamp) weight
        grid."""
        from pde_inverse.problems import KineticFokkerPlanckOU

        cfg = apply_overrides(
            Config(),
            [
                "pde_instance.name=Kinetic-Fokker-Planck",
                "pde_instance.potential=Quadratic",
                "pde_instance.domain_dim=2",
                "pde_instance.init_broaden=1.5",
            ],
        )
        inst = KineticFokkerPlanckOU(cfg, rng)
        with pytest.raises(ValueError, match="grid_time"):
            inst.sample_ground_truth_weighted(rng, 400)


def _kmv_cfg(*extra):
    return apply_overrides(
        Config(),
        [
            "pde_instance.name=Kinetic-McKean-Vlasov",
            "pde_instance.domain_dim=2",
            "pde_instance.total_evolving_time=1",
            "solver.train.sample_mode=grid_time",
            "solver.train.n_time_stamps=3",
            "solver.train.sample_per_time=24",
            "solver.train.batch_size_init=0",
            "solver.train.batch_size_terminal=0",
            *extra,
        ],
    )


class TestExactLawSampler:
    """The exact-law (KFP-OU / KMV) broadened sampler: per-stamp law
    N(m_t, s^2 P_t) with exact weights from the sampling noise itself."""

    def test_weights_bounded_and_unit_mean(self, rng):
        from pde_inverse.problems import KineticMcKeanVlasovQuadratic

        s = 1.5
        cfg = _kmv_cfg(f"pde_instance.init_broaden={s}")
        inst = KineticMcKeanVlasovQuadratic(cfg, rng)
        out = inst.sample_ground_truth_weighted(
            jax.random.fold_in(rng, 1), (3, 40_000)
        )
        w = np.asarray(out["w_0T"])
        assert w.max() <= s ** (2 * inst.dim) * (1 + 1e-5)
        assert abs(w.mean() - 1.0) < 0.02

    def test_weighted_moment_is_unbiased(self, rng):
        """E_q[w ||z||^2] per stamp must equal the oracle's exact
        tr(P_t) + ||m_t||^2."""
        from pde_inverse.problems import KineticMcKeanVlasovQuadratic

        cfg = _kmv_cfg("pde_instance.init_broaden=1.5")
        inst = KineticMcKeanVlasovQuadratic(cfg, rng)
        nt, per = 3, 120_000
        rng_b = jax.random.fold_in(rng, 2)
        out = inst.sample_ground_truth_weighted(rng_b, (nt, per))
        ts = inst.get_time_sample_ground_truth(rng_b, (nt, per))
        means, covs = inst.oracle.moments_grid(ts)
        exact = jnp.trace(covs, axis1=-2, axis2=-1) + jnp.sum(means**2, -1)
        z = out["0T"].reshape(per, nt, -1)
        w = out["w_0T"].reshape(per, nt)
        est = np.asarray(jnp.mean(w * jnp.sum(z**2, -1), axis=0))
        np.testing.assert_allclose(est, np.asarray(exact), rtol=0.03)

    def test_s1_reproduces_plain_sampler_bitwise(self, rng):
        from pde_inverse.problems import KineticMcKeanVlasovQuadratic

        cfg = _kmv_cfg()  # init_broaden = 1.0
        inst = KineticMcKeanVlasovQuadratic(cfg, rng)
        rng_b = jax.random.fold_in(rng, 3)
        plain = inst.sample_ground_truth(rng_b, (3, 24))
        out = inst.sample_ground_truth_weighted(rng_b, (3, 24))
        np.testing.assert_array_equal(np.asarray(plain), np.asarray(out["0T"]))
        np.testing.assert_array_equal(
            np.asarray(out["w_0T"]), np.ones(plain.shape[0])
        )


class TestExactLawKMVLoss:
    """Tail-boost through the KMV collapse paths: both expectation layers
    (outer point means and inner mean-field ref statistics) reweighted."""

    def _quad_setup(self, rng, broaden):
        from pde_inverse.problems import KineticMcKeanVlasovQuadratic

        extra = (
            [f"pde_instance.init_broaden={broaden}"] if broaden > 1 else []
        )
        cfg = _kmv_cfg(*extra)
        inst = KineticMcKeanVlasovQuadratic(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        net, params = method.create_model_fn()  # registers the closed form
        return inst, net, params, method

    def test_weighted_keys_present(self, rng):
        inst, net, params, method = self._quad_setup(rng, 1.5)
        data = jax.jit(method.sample_data)(jax.random.fold_in(rng, 4))
        assert "w_0T" in data
        assert data["w_0T"].shape == (data["0T"].shape[0],)
        assert "tau_0T" in data

    def test_unit_weights_identity_quadratic(self, rng):
        """w = 1 arrays through the weighted closed-form collapse must
        reproduce the plain path to float tolerance (the weighted branch
        uses the algebraically-equal uncentered moment form)."""
        from pde_inverse.losses import kinetic_mckean_vlasov as kmv

        inst, net, params, method = self._quad_setup(rng, 1.0)
        data = jax.jit(method.sample_data)(jax.random.fold_in(rng, 5))
        weighted = dict(data, w_0T=jnp.ones(data["0T"].shape[0]))
        out_p = kmv.value_and_grad_fn(
            net.apply, params, data, rng, inst, closed_form_quadratic=True
        )
        out_w = kmv.value_and_grad_fn(
            net.apply, params, weighted, rng, inst, closed_form_quadratic=True
        )
        np.testing.assert_allclose(
            float(out_p["loss"]), float(out_w["loss"]), rtol=2e-5
        )
        for a, b in zip(
            jax.tree_util.tree_leaves(out_p["grad"]),
            jax.tree_util.tree_leaves(out_w["grad"]),
        ):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=2e-4, atol=1e-6
            )

    def test_unit_weights_identity_fourier(self, rng):
        """Same identity through the fourier-kernel collapse (with
        quadratic head: exercises the weighted _quad_head_stats path)."""
        from pde_inverse.losses import kinetic_mckean_vlasov as kmv
        from pde_inverse.models.fourier_kernel import FourierKernelModel
        from pde_inverse.problems import KineticMcKeanVlasovQuadratic

        cfg = _kmv_cfg()
        inst = KineticMcKeanVlasovQuadratic(cfg, rng)
        net = FourierKernelModel(dim=inst.dim, n_features=8, quadratic_head=True)
        params = net.init(jax.random.PRNGKey(0), jnp.zeros(inst.dim))
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        data = jax.jit(method.sample_data)(jax.random.fold_in(rng, 6))
        weighted = dict(data, w_0T=jnp.ones(data["0T"].shape[0]))
        kwargs = dict(blockwise_module=net)
        out_p = kmv.value_and_grad_fn(
            net.apply, params, data, rng, inst, **kwargs
        )
        out_w = kmv.value_and_grad_fn(
            net.apply, params, weighted, rng, inst, **kwargs
        )
        np.testing.assert_allclose(
            float(out_p["loss"]), float(out_w["loss"]), rtol=2e-5
        )
        for a, b in zip(
            jax.tree_util.tree_leaves(out_p["grad"]),
            jax.tree_util.tree_leaves(out_w["grad"]),
        ):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=2e-4, atol=1e-6
            )

    def test_weighted_collapse_matches_bruteforce(self, rng):
        """Deterministic equality: with arbitrary per-(ref, stamp) weights
        w, both weighted collapse paths must reproduce the brute-force
        weighted pairwise sums (1/m) sum_j w_{j,t} {Phi, grad Phi,
        v^T Hess Phi v}(x - r_j) exactly (to float tolerance)."""
        from pde_inverse.losses import fourier_meanfield as fmf
        from pde_inverse.losses.kinetic_mckean_vlasov import (
            _quadratic_meanfield_stats,
        )
        from pde_inverse.models.fourier_kernel import FourierKernelModel

        n, nt, d = 9, 3, 2
        kx, kv, kw, kp = jax.random.split(rng, 4)
        x = jax.random.normal(kx, (n, nt, d))
        v = jax.random.normal(kv, (n, nt, d))
        w = jax.random.uniform(kw, (n, nt), minval=0.2, maxval=2.0)

        def brute(Phi):
            diff = x[None] - x[:, None]  # [m, n, nt, d]
            val3 = jax.vmap(jax.vmap(jax.vmap(Phi)))
            grad3 = jax.vmap(jax.vmap(jax.vmap(jax.grad(Phi))))

            def quad(xi, vi):
                _, hv = jax.jvp(jax.grad(Phi), (xi,), (vi,))
                return jnp.dot(vi, hv)

            quad3 = jax.vmap(jax.vmap(jax.vmap(quad, (0, 0)), (0, 0)), (0, None))
            wm = w[:, None, :]  # ref-axis weights broadcast over n
            return {
                "value": jnp.mean(wm * val3(diff), axis=0),
                "nabla": jnp.mean(wm[..., None] * grad3(diff), axis=0),
                "hess": jnp.mean(wm * quad3(diff, v), axis=0),
            }

        # fourier-kernel collapse (quadratic head on)
        net = FourierKernelModel(dim=d, n_features=8, quadratic_head=True)
        params = net.init(kp, jnp.zeros(d))
        got = fmf.meanfield_stats(net, params, x, v, x, ref_weights=w)
        Phi_fk = lambda xi: net.apply(params, xi)[0]
        want = brute(Phi_fk)
        for k in ("value", "nabla", "hess"):
            np.testing.assert_allclose(
                np.asarray(got[k]), np.asarray(want[k]), rtol=5e-5, atol=1e-6
            )

        # quadratic closed-form collapse
        A = jax.random.normal(jax.random.fold_in(rng, 11), (d, d))
        Phi_q = lambda y: 0.5 * jnp.dot(y, (A.T @ A) @ y) + jnp.dot(
            jnp.ones(d), y
        )
        got_q = _quadratic_meanfield_stats(Phi_q, x, v, ref_weights=w)
        want_q = brute(Phi_q)
        for k in ("value", "nabla", "hess"):
            np.testing.assert_allclose(
                np.asarray(got_q[k]), np.asarray(want_q[k]), rtol=5e-5, atol=1e-6
            )

    def test_weighted_loss_matches_plain_in_expectation(self, rng):
        """End-to-end unbiasedness through methods.sample_data + the
        closed-form collapse: averaged over independent batches at fixed
        params, broadened+weighted and plain losses must agree."""
        from functools import partial

        inst_p, net, params, method_p = self._quad_setup(rng, 1.0)
        _, _, _, method_w = self._quad_setup(rng, 1.3)

        def mean_loss(method, n=32):
            vg = jax.jit(partial(method.value_and_grad_fn, net.apply, params))
            keys = jax.random.split(jax.random.fold_in(rng, 9), n)
            return np.mean([float(vg(k)["loss"]) for k in keys])

        mp = mean_loss(method_p)
        mw = mean_loss(method_w)
        assert abs(mp - mw) / max(abs(mp), 1.0) < 0.15

    def test_pairwise_paths_are_rejected(self, rng):
        """Importance weights only thread through the collapse paths; the
        generic O(n^2) pairwise reduction must refuse them loudly."""
        from pde_inverse.losses import kinetic_mckean_vlasov as kmv
        from pde_inverse.models.mlp import PotentialMLP

        inst, _, _, method = self._quad_setup(rng, 1.5)
        data = jax.jit(method.sample_data)(jax.random.fold_in(rng, 7))
        net = PotentialMLP(hidden_dims=[8], feature_dim=8)
        params = net.init(jax.random.PRNGKey(0), jnp.zeros(inst.dim))
        with pytest.raises(ValueError, match="collapse"):
            kmv.value_and_grad_fn(net.apply, params, data, rng, inst)


class TestAnnealedDose:
    """pde_instance.init_broaden_decay_steps: cosine-anneal the dose s ->
    1.0 as a traced per-step scalar.  The weights are exact at every s, so
    each step's estimator is individually unbiased — the schedule only
    moves where the sampling variance is spent (early tail coverage,
    late unweighted bulk)."""

    def _quad_setup(self, rng, *extra):
        from pde_inverse.problems import KineticMcKeanVlasovQuadratic

        cfg = _kmv_cfg(*extra)
        inst = KineticMcKeanVlasovQuadratic(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        net, params = method.create_model_fn()
        return inst, net, params, method

    def test_explicit_s_matches_config_s_bitwise(self, rng):
        from pde_inverse.problems import KineticMcKeanVlasovQuadratic

        cfg_a = _kmv_cfg("pde_instance.init_broaden=1.3")
        cfg_b = _kmv_cfg("pde_instance.init_broaden=1.7")
        rng_b = jax.random.fold_in(rng, 11)
        out_a = KineticMcKeanVlasovQuadratic(
            cfg_a, rng
        ).sample_ground_truth_weighted(rng_b, (3, 24))
        out_b = KineticMcKeanVlasovQuadratic(
            cfg_b, rng
        ).sample_ground_truth_weighted(rng_b, (3, 24), s=1.3)
        np.testing.assert_array_equal(
            np.asarray(out_a["0T"]), np.asarray(out_b["0T"])
        )
        np.testing.assert_array_equal(
            np.asarray(out_a["w_0T"]), np.asarray(out_b["w_0T"])
        )

    def test_schedule_endpoints_and_monotonicity(self, rng):
        _, _, _, method = self._quad_setup(
            rng,
            "pde_instance.init_broaden=1.5",
            "pde_instance.init_broaden_decay_steps=100",
        )
        s = [float(method._broaden_s(t)) for t in (0, 25, 50, 75, 100, 200)]
        np.testing.assert_allclose(s[0], 1.5, rtol=1e-6)
        assert s[-2] == 1.0 and s[-1] == 1.0  # exactly unweighted at decay
        assert all(a >= b for a, b in zip(s, s[1:]))  # monotone decay
        # off-switches return None (samplers use the static config dose)
        assert method._broaden_s(None) is None
        _, _, _, m_off = self._quad_setup(rng, "pde_instance.init_broaden=1.5")
        assert m_off._broaden_s(0) is None

    def test_late_step_weights_are_unit(self, rng):
        """Past the decay horizon the sampler must reproduce the
        unweighted batch: w == 1 and samples equal the plain sampler's."""
        inst, net, params, method = self._quad_setup(
            rng,
            "pde_instance.init_broaden=1.5",
            "pde_instance.init_broaden_decay_steps=10",
        )
        rng_b = jax.random.fold_in(rng, 12)
        data = jax.jit(
            lambda r, t: method.sample_data(r, broaden_s=method._broaden_s(t))
        )(rng_b, 50)
        np.testing.assert_allclose(
            np.asarray(data["w_0T"]), np.ones(data["0T"].shape[0]), rtol=1e-6
        )

    def test_traced_through_value_and_grad(self, rng):
        """The step-dependent dose must trace through the jitted training
        objective: losses at step 0 (full dose) and past the horizon
        (unit dose) both finite, gradients well-defined."""
        from functools import partial

        _, net, params, method = self._quad_setup(
            rng,
            "pde_instance.init_broaden=1.5",
            "pde_instance.init_broaden_decay_steps=20",
        )
        vg = jax.jit(
            partial(method.value_and_grad_fn, net.apply, params),
            static_argnames=(),
        )
        for t in (0, 40):
            out = vg(jax.random.fold_in(rng, 13), step=jnp.asarray(t))
            assert np.isfinite(float(out["loss"]))

    def test_sde_family_rejects_schedule(self, rng):
        cfg = make_cfg(
            [
                "pde_instance.init_broaden=1.5",
                "pde_instance.init_broaden_decay_steps=100",
            ]
        )
        inst = KineticFokkerPlanckGMM(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        with pytest.raises(ValueError, match="exact-law"):
            method._broaden_s(0)
