"""Loss-semantics tests.

Each consistency loss is checked against an independent naive
implementation written inline here (direct vmapped autodiff of the
reference's五-term formulas), so refactors of the fused/chunked versions are
gated by exact-semantics equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_inverse.config import Config, apply_overrides
from pde_inverse.losses import fokker_planck as fp_loss
from pde_inverse.losses import kinetic_fokker_planck as kfp_loss
from pde_inverse.losses import kinetic_mckean_vlasov as kmv_loss
from pde_inverse.methods import ConsistencyBased
from pde_inverse.problems import (
    FokkerPlanck,
    KineticFokkerPlanckOU,
    KineticMcKeanVlasovQuadratic,
)


def _cfg(name, dim=2, **extra):
    overrides = [
        f"pde_instance.name={name}",
        f"pde_instance.domain_dim={dim}",
        "pde_instance.total_evolving_time=2",
    ] + [f"{k}={v}" for k, v in extra.items()]
    return apply_overrides(Config(), overrides)


def _hvp_quad_naive(V, x, v):
    def one(xi, vi):
        g = jax.grad(V)
        _, hv = jax.jvp(g, (xi,), (vi,))
        return jnp.dot(vi, hv)

    return jax.vmap(one)(x, v)


class TestKFPLoss:
    def test_matches_naive_formula(self, rng):
        dim = 2
        cfg = _cfg("Kinetic-Fokker-Planck", dim)
        inst = KineticFokkerPlanckOU(cfg, rng)
        net = inst.create_parametric_model()
        params = net.init(jax.random.PRNGKey(0), jnp.zeros(dim))

        keys = jax.random.split(rng, 3)
        data = {
            "initial": inst.distribution_initial.sample(64, keys[0]),
            "terminal": inst.distribution_terminal.sample(64, keys[1]),
            "0T": inst.sample_ground_truth(keys[2], (4, 32)),
        }

        out = kfp_loss.value_and_grad_fn(net.apply, params, data, rng, inst)

        # naive independent implementation
        V = lambda x: net.apply(params, x)[0]
        xi, vi = jnp.split(data["initial"], 2, -1)
        xt, vt = jnp.split(data["terminal"], 2, -1)
        x0, v0 = jnp.split(data["0T"], 2, -1)
        nab = jax.vmap(jax.grad(V))
        nab_true = jax.vmap(jax.grad(inst.V_true_fn))
        T = inst.total_evolving_time
        g = inst.gamma_friction
        expected = (
            jnp.mean(jnp.sum(nab(x0) ** 2, -1))
            - 2 * jnp.mean(_hvp_quad_naive(V, x0, v0))
            + 2 * g * jnp.mean(jnp.sum(nab(x0) * v0, -1))
            + jnp.mean(jnp.sum(nab_true(x0) ** 2, -1))
            + (
                2 * jnp.mean(jnp.sum(nab(xt) * vt, -1))
                - 2 * jnp.mean(jnp.sum(nab(xi) * vi, -1))
            )
            / T
        )
        np.testing.assert_allclose(out["loss"], expected, rtol=1e-5)
        assert jnp.isfinite(out["grad_norm"])
        assert out["loss ground truth"] >= 0

    def test_gap_zero_at_truth(self, rng):
        """With the parametric model initialized AT the true drift, the
        ground-truth diagnostic must vanish."""
        dim = 2
        cfg = _cfg("Kinetic-Fokker-Planck", dim)
        inst = KineticFokkerPlanckOU(cfg, rng)
        net = inst.create_parametric_model()
        params = net.init(jax.random.PRNGKey(0), jnp.zeros(dim))
        # set W = tilde_F / 2 (so W + W^T = tilde_F), b = 0
        params = jax.tree_util.tree_map(lambda x: x, params)
        params = {
            "params": {
                "F": {
                    "kernel": inst.tilde_F / 2.0,
                    "bias": jnp.zeros(dim),
                }
            }
        }
        data = {
            "initial": inst.distribution_initial.sample(32, rng),
            "terminal": inst.distribution_terminal.sample(32, rng),
            "0T": inst.sample_ground_truth(rng, (2, 16)),
        }
        out = kfp_loss.value_and_grad_fn(net.apply, params, data, rng, inst)
        np.testing.assert_allclose(out["loss ground truth"], 0.0, atol=1e-9)


class TestFPLoss:
    def test_matches_naive_formula(self, rng):
        dim = 3
        cfg = _cfg("Fokker-Planck", dim)
        inst = FokkerPlanck(cfg, rng)
        net = inst.create_parametric_model()
        params = net.init(jax.random.PRNGKey(0), jnp.zeros(dim))
        keys = jax.random.split(rng, 3)
        data = {
            "initial": inst.distribution_initial.sample(64, keys[0]),
            "terminal": inst.distribution_terminal.sample(64, keys[1]),
            "0T": inst.sample_ground_truth(keys[2], 128),
        }
        out = fp_loss.value_and_grad_fn(net.apply, params, data, rng, inst)

        V = lambda x: net.apply(params, x)[0]
        lap = jax.vmap(lambda xi: jnp.trace(jax.hessian(V)(xi)))
        nab = jax.vmap(jax.grad(V))
        nab_true = jax.vmap(jax.grad(inst.V_true_fn))
        T = inst.total_evolving_time
        expected = (
            jnp.mean(jnp.sum(nab(data["0T"]) ** 2, -1))
            - 2 * jnp.mean(lap(data["0T"]))
            + jnp.mean(jnp.sum(nab_true(data["0T"]) ** 2, -1))
            + (
                2 * jnp.mean(jax.vmap(V)(data["terminal"]))
                - 2 * jnp.mean(jax.vmap(V)(data["initial"]))
            )
            / T
        )
        np.testing.assert_allclose(out["loss"], expected, rtol=1e-4)

    def test_test_fn_small_at_truth(self, rng):
        dim = 2
        cfg = _cfg("Fokker-Planck", dim)
        inst = FokkerPlanck(cfg, rng)
        net = inst.create_parametric_model()
        params = {
            "params": {"F": {"kernel": inst.F / 2.0, "bias": jnp.zeros(dim)}}
        }
        from functools import partial

        metrics = fp_loss.test_fn(partial(net.apply, params), inst, rng, batch_size=256)
        for v in metrics.values():
            assert v < 1e-5


class TestKMVLoss:
    def _setup(self, rng, n=24, n_time=3, dim=2):
        cfg = _cfg("Kinetic-McKean-Vlasov", dim)
        inst = KineticMcKeanVlasovQuadratic(cfg, rng)
        net = inst.create_parametric_model()
        params = net.init(jax.random.PRNGKey(0), jnp.zeros(dim))
        data = {
            "0T": inst.sample_ground_truth(rng, (n_time, n)),
            "tau_0T": inst.get_time_sample_ground_truth(rng, (n_time, n)),
        }
        return inst, net, params, data

    def test_chunked_matches_naive_pairwise(self, rng):
        """The chunked ref-axis scan must equal the naive full [m,n,t,d]
        pairwise-tensor implementation exactly."""
        inst, net, params, data = self._setup(rng)
        out = kmv_loss.value_and_grad_fn(net.apply, params, data, rng, inst)

        # naive implementation with full pairwise tensor
        taus = data["tau_0T"]
        nt = taus.shape[0]
        x, v = jnp.split(data["0T"], 2, -1)
        d = x.shape[-1]
        x = x.reshape(-1, nt, d)
        v = v.reshape(-1, nt, d)
        diff = x[None] - x[:, None]  # [m, n, nt, d]

        Phi = lambda xx: net.apply(params, xx)[0]
        val3 = jax.vmap(jax.vmap(jax.vmap(Phi)))
        grad3 = jax.vmap(jax.vmap(jax.vmap(jax.grad(Phi))))

        def quad(xi, vi):
            _, hv = jax.jvp(jax.grad(Phi), (xi,), (vi,))
            return jnp.dot(vi, hv)

        quad3 = jax.vmap(jax.vmap(jax.vmap(quad, (0, 0)), (0, 0)), (0, None))
        grad3_true = jax.vmap(jax.vmap(jax.vmap(jax.grad(inst.Phi_true_fn))))

        w = jax.vmap(
            lambda s, xs: inst.partial_s2_log_density_fn(s, xs)
            + inst.partial_s_log_density_fn(s, xs) ** 2
            + inst.gamma_friction * inst.partial_s_log_density_fn(s, xs),
            in_axes=(0, 1),
            out_axes=1,
        )(taus, x)  # [n, nt]

        loss_nabla = jnp.mean(jnp.sum(jnp.mean(grad3(diff), 0) ** 2, -1))
        loss_hess = jnp.mean(jnp.mean(quad3(diff, v), 0))
        loss_value = jnp.mean(jnp.mean(val3(diff), 0) * w)
        loss_true = jnp.mean(jnp.sum(jnp.mean(grad3_true(diff), 0) ** 2, -1))
        expected = loss_nabla - 2 * loss_hess + 2 * loss_value + loss_true

        np.testing.assert_allclose(out["loss"], expected, rtol=2e-4)

    def test_chunk_padding_consistency(self, rng):
        """Chunk sizes that do and don't divide m must agree (mask path)."""
        inst, net, params, data = self._setup(rng, n=10)
        l_full = kmv_loss.make_loss_fn(net.apply, data, inst, ref_chunk=10)
        l_c3 = kmv_loss.make_loss_fn(net.apply, data, inst, ref_chunk=3)
        l_c4 = kmv_loss.make_loss_fn(net.apply, data, inst, ref_chunk=4)
        a, b, c = l_full(params)[0], l_c3(params)[0], l_c4(params)[0]
        np.testing.assert_allclose(a, b, rtol=1e-5)
        np.testing.assert_allclose(a, c, rtol=1e-5)
        # element_budget clamps the chunk the same way an explicit
        # ref_chunk does — values must be identical for any budget
        l_b = kmv_loss.make_loss_fn(net.apply, data, inst, element_budget=16)
        np.testing.assert_allclose(a, l_b(params)[0], rtol=1e-5)

    def test_gap_zero_at_truth(self, rng):
        inst, net, params, data = self._setup(rng)
        dim = 2
        params = {
            "params": {"F": {"kernel": inst.tilde_F / 2.0, "bias": jnp.zeros(dim)}}
        }
        loss_fn = kmv_loss.make_loss_fn(net.apply, data, inst)
        np.testing.assert_allclose(loss_fn(params)[1], 0.0, atol=1e-8)

    def test_field_reg_adds_probe_gradient_penalty(self, rng):
        """field_reg adds EXACTLY lambda * mean ||grad Phi||^2 over the
        documented strided probe pairs, leaves the gap untouched, and
        flows into the parameter gradient."""
        inst, net, params, data = self._setup(rng)
        lam, n_probe = 0.37, 16
        base = kmv_loss.make_loss_fn(net.apply, data, inst)
        reg = kmv_loss.make_loss_fn(
            net.apply, data, inst, field_reg=lam, field_reg_probes=n_probe
        )
        (l0, gap0), (l1, gap1) = base(params), reg(params)

        taus = data["tau_0T"]
        nt = taus.shape[0]
        x, _ = jnp.split(data["0T"], 2, -1)
        d = x.shape[-1]
        xf = x.reshape(-1, nt, d).reshape(-1, d)
        n_pts = xf.shape[0]
        n_p = min(n_probe, n_pts)
        ii = jnp.arange(n_p) % n_pts
        off = (7919 * nt) % n_pts or nt % n_pts
        jj = (ii + off) % n_pts
        # the offset is a multiple of nt => probe pairs share a stamp
        assert off % nt == 0
        probes = xf[ii] - xf[jj]
        g = jax.vmap(jax.grad(lambda xi: net.apply(params, xi)[0]))(probes)
        expected = lam * jnp.mean(jnp.sum(g**2, -1))

        np.testing.assert_allclose(l1 - l0, expected, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(gap0, gap1, rtol=1e-6)
        # the penalty must reach the PARAMETER gradient: grads of the
        # regularized and base losses must differ (a stop_gradient'ed
        # penalty would pass the value check above but not this)
        g_reg = jax.grad(lambda p: reg(p)[0])(params)
        g_base = jax.grad(lambda p: base(p)[0])(params)
        diff = jax.tree_util.tree_reduce(
            jnp.add,
            jax.tree_util.tree_map(
                lambda a, b: jnp.sum(jnp.abs(a - b)), g_reg, g_base
            ),
            jnp.zeros(()),
        )
        assert float(diff) > 1e-8

    def test_field_reg_correction_only_excludes_quad_head(self, rng):
        """Semiparametric field reg for the MLP+quad class: (a) with the
        head's params at zero the correction-only penalty equals the
        full-field penalty; (b) with a nonzero head the loss gap is
        exactly lam * E[||g||^2 - ||g - g_quad||^2]; (c) without a quad
        head the flag raises."""
        from pde_inverse.models.mlp import PotentialMLP

        inst, _, _, data = self._setup(rng)
        lam, n_probe, d = 0.37, 32, 2
        net = PotentialMLP(
            hidden_dims=[8, 8], feature_dim=8, quadratic_head=True
        )
        params = net.init(jax.random.PRNGKey(3), jnp.zeros(d))
        common = dict(
            data=data, pde_instance=inst, field_reg=lam,
            field_reg_probes=n_probe,
        )
        l_full = kmv_loss.make_loss_fn(net.apply, **common)
        l_corr = kmv_loss.make_loss_fn(
            net.apply, field_reg_correction_only=True, **common
        )

        # (a) zero head => identical penalties
        p0 = dict(params["params"])
        p0["quad_A"] = jnp.zeros((d, d))
        p0["quad_b"] = jnp.zeros((d,))
        params0 = {"params": p0}
        np.testing.assert_allclose(
            float(l_corr(params0)[0]), float(l_full(params0)[0]), rtol=1e-6
        )

        # (b) nonzero head: reconstruct the penalty gap from the
        # documented strided probe pairs
        ph = dict(params["params"])
        ph["quad_A"] = 0.5 * jnp.eye(d) + 0.1
        ph["quad_b"] = jnp.array([0.2, -0.1])
        params_h = {"params": ph}
        full, corr = float(l_full(params_h)[0]), float(l_corr(params_h)[0])
        assert full != pytest.approx(corr)

        nt = data["tau_0T"].shape[0]
        x, _ = jnp.split(data["0T"], 2, -1)
        xf = x.reshape(-1, nt, d).reshape(-1, d)
        n_pts = xf.shape[0]
        ii = jnp.arange(min(n_probe, n_pts)) % n_pts
        off = (7919 * nt) % n_pts or nt % n_pts
        probe = xf[ii] - xf[(ii + off) % n_pts]
        g = jax.vmap(jax.grad(lambda xi: net.apply(params_h, xi)[0]))(probe)
        gq = probe @ (ph["quad_A"].T @ ph["quad_A"]) + ph["quad_b"]
        gap_want = lam * float(
            jnp.mean(jnp.sum(g**2, -1) - jnp.sum((g - gq) ** 2, -1))
        )
        np.testing.assert_allclose(full - corr, gap_want, rtol=1e-4)

        # (c) headless module => trace-time error
        net_nh = PotentialMLP(hidden_dims=[8, 8], feature_dim=8)
        params_nh = net_nh.init(jax.random.PRNGKey(3), jnp.zeros(d))
        l_nh = kmv_loss.make_loss_fn(
            net_nh.apply, field_reg_correction_only=True, **common
        )
        with pytest.raises(ValueError, match="quadratic head"):
            l_nh(params_nh)

    def test_closed_form_quadratic_matches_pairwise(self, rng):
        """The O(n) sufficient-statistics fast path for exactly-quadratic
        kernels must reproduce the O(n^2) pairwise loss, gap, and params
        gradient."""
        inst, net, params, data = self._setup(rng, n=20, n_time=3)
        # a generic (non-symmetric kernel + bias) quadratic model state
        params = {
            "params": {
                "F": {
                    "kernel": jax.random.normal(rng, (2, 2)),
                    "bias": jax.random.normal(jax.random.fold_in(rng, 1), (2,)),
                }
            }
        }
        out_pair = kmv_loss.value_and_grad_fn(
            net.apply, params, data, rng, inst, closed_form_quadratic=False
        )
        out_cf = kmv_loss.value_and_grad_fn(
            net.apply, params, data, rng, inst, closed_form_quadratic=True
        )
        np.testing.assert_allclose(out_cf["loss"], out_pair["loss"], rtol=2e-5)
        np.testing.assert_allclose(
            out_cf["loss ground truth"], out_pair["loss ground truth"], rtol=2e-5,
            atol=1e-7,
        )
        for a, b in zip(
            jax.tree_util.tree_leaves(out_cf["grad"]),
            jax.tree_util.tree_leaves(out_pair["grad"]),
        ):
            np.testing.assert_allclose(a, b, rtol=3e-4, atol=1e-6)

    def test_pairwise_true_side_matches_closed_form(self, rng, monkeypatch):
        """Every KMV instance declares phi_true_is_quadratic, so the
        generic pairwise true-side branch is normally bypassed; force the
        attribute off and check the pairwise reduction reproduces the
        closed-form sufficient statistics (loss and gap)."""
        inst, net, params, data = self._setup(rng, n=12)
        out_cf = kmv_loss.value_and_grad_fn(net.apply, params, data, rng, inst)
        assert getattr(inst, "phi_true_is_quadratic", False)
        monkeypatch.setattr(inst, "phi_true_is_quadratic", False, raising=False)
        out_pw = kmv_loss.value_and_grad_fn(net.apply, params, data, rng, inst)
        np.testing.assert_allclose(out_pw["loss"], out_cf["loss"], rtol=2e-5)
        np.testing.assert_allclose(
            out_pw["loss ground truth"],
            out_cf["loss ground truth"],
            rtol=2e-5,
            atol=1e-7,
        )

    def test_method_dispatches_closed_form(self, rng):
        """ConsistencyBased enables the fast path exactly for the
        parametric QuadraticFormModel (and the config can disable it)."""
        from pde_inverse.methods import ConsistencyBased

        cfg = _cfg("Kinetic-McKean-Vlasov", 2)
        inst = KineticMcKeanVlasovQuadratic(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        net, params = method.create_model_fn()
        assert method._kmv_closed_form()

        from pde_inverse.config import apply_overrides

        cfg_off = apply_overrides(cfg, ["solver.train.kmv_closed_form=False"])
        method_off = ConsistencyBased(pde_instance=inst, cfg=cfg_off, rng=rng)
        method_off.create_model_fn()
        assert not method_off._kmv_closed_form()

        cfg_np = apply_overrides(cfg, ["estimation_mode=non-parametric"])
        method_np = ConsistencyBased(pde_instance=inst, cfg=cfg_np, rng=rng)
        method_np.create_model_fn()
        assert not method_np._kmv_closed_form()

    def test_field_reg_cosine_anneal_matches_constant_lambda(self, rng):
        """kmv_field_reg_decay_steps cosine-anneals the stabilizer strength
        from kmv_field_reg to kmv_field_reg_floor: the step-annealed loss at
        step s equals the constant-lambda loss evaluated at lambda(s), for
        lambda(0)=lam0, lambda(D/2)=(lam0+floor)/2, lambda(>=D)=floor."""
        from pde_inverse.config import apply_overrides
        from pde_inverse.methods import ConsistencyBased

        lam0, floor, D = 0.32, 0.02, 100

        def build(overrides):
            cfg = _cfg(
                "Kinetic-McKean-Vlasov",
                2,
                **{
                    "estimation_mode": "non-parametric",
                    "neural_network.hidden_dim": 8,
                    "neural_network.layers": 2,
                    "neural_network.feature_dim": 8,
                    "solver.train.n_time_stamps": 3,
                    "solver.train.sample_per_time": 16,
                    "solver.train.kmv_field_reg_probes": 32,
                },
            )
            cfg = apply_overrides(cfg, overrides)
            inst = KineticMcKeanVlasovQuadratic(cfg, rng)
            method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
            net, params = method.create_model_fn()
            return method, net, params

        annealed, net, params = build(
            [
                f"solver.train.kmv_field_reg={lam0}",
                f"solver.train.kmv_field_reg_decay_steps={D}",
                f"solver.train.kmv_field_reg_floor={floor}",
            ]
        )
        key = jax.random.PRNGKey(7)
        for s, lam_s in [
            (0, lam0),
            (D // 2, 0.5 * (lam0 + floor)),
            (D, floor),
            (3 * D, floor),
        ]:
            const, _, _ = build([f"solver.train.kmv_field_reg={lam_s}"])
            # same rng => identical sampled batch; traced step as the
            # trainer's scan carry passes it
            loss_a = jax.jit(
                lambda p, k, st: annealed.value_and_grad_fn(
                    net.apply, p, k, step=st
                )["loss"]
            )(params, key, jnp.asarray(s, jnp.int32))
            loss_c = const.value_and_grad_fn(net.apply, params, key)["loss"]
            np.testing.assert_allclose(loss_a, loss_c, rtol=1e-6, atol=1e-7)


class TestSampleDataPolicy:
    def test_online_exact_grid(self, rng):
        cfg = _cfg(
            "Kinetic-Fokker-Planck",
            2,
            **{
                "solver.train.sample_mode": "grid_time",
                "solver.train.n_time_stamps": 4,
                "solver.train.sample_per_time": 8,
                "solver.train.batch_size_init": 16,
                "solver.train.batch_size_terminal": 16,
            },
        )
        inst = KineticFokkerPlanckOU(cfg, rng)
        method = ConsistencyBased(pde_instance=inst, cfg=cfg, rng=rng)
        data = method.sample_data(rng)
        assert data["initial"].shape == (16, 4)
        assert data["0T"].shape == (32, 4)
        assert data["tau_0T"].shape == (4,)
        # times aligned: 0T reshaped [per, nt, D] means column j drawn at tau j
        x = data["0T"].reshape(8, 4, 4)
        # stamps are increasing and within (0, T]
        taus = data["tau_0T"]
        assert (jnp.diff(taus) > 0).all()
        assert (taus >= 0).all() and (taus <= 2.0).all()

    def test_grid_sample_layout_statistics(self, rng):
        """Column j of the reshaped grid batch must follow the law at tau_j:
        catches the reference's scramble-reshape bug (…OU.py:176-190)."""
        cfg = _cfg(
            "Kinetic-Fokker-Planck",
            2,
            **{
                "solver.train.sample_mode": "grid_time",
                "solver.train.n_time_stamps": 3,
                "solver.train.sample_per_time": 4096,
            },
        )
        inst = KineticFokkerPlanckOU(cfg, rng)
        samples = inst.sample_ground_truth(rng, (3, 4096))
        taus = inst.get_time_sample_ground_truth(rng, (3, 4096))
        z = samples.reshape(4096, 3, 4)
        means, covs = inst.oracle.moments_grid(taus)
        for j in range(3):
            np.testing.assert_allclose(z[:, j].mean(0), means[j], atol=0.15)
            np.testing.assert_allclose(
                jnp.cov(z[:, j].T), covs[j], atol=0.25
            )
