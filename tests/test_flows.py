"""Normalizing-flow tests: invertibility, exact log-det, identity-at-t=0,
and a tiny MLE sanity run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_inverse.density.flows import (
    MaskedNormalizingFlow,
    build_realnvp,
    make_masks,
)
from pde_inverse.ops.gaussian import gaussian_logdensity


def _flow(dim=2, **kw):
    defaults = dict(
        dim=dim,
        couple_mul=2,
        mask_type="loop",
        soft_init=1.0,
        ignore_time=False,
        activation="celu",
        embed_time_dim=6,
    )
    defaults.update(kw)
    return MaskedNormalizingFlow(**defaults)


class TestMasks:
    def test_loop_masks(self):
        m = make_masks(3, 2, "loop")
        assert m.shape == (6, 3)
        assert (m.sum(1) == 2).all()

    def test_random_masks_nondegenerate(self):
        m = make_masks(4, 5, "random")
        assert m.shape == (5, 4)
        assert ((m.sum(1) > 0) & (m.sum(1) < 4)).all()


class TestFlow:
    def test_invertibility(self, rng):
        flow = _flow()
        x = jax.random.normal(rng, (16, 2))
        t = jnp.float32(0.7)
        params = flow.init(jax.random.PRNGKey(0), t, x, False)
        y, ldj_f = flow.apply(params, t, x, False)
        x_back, ldj_r = flow.apply(params, t, y, True)
        np.testing.assert_allclose(x_back, x, atol=1e-5)
        np.testing.assert_allclose(ldj_f + ldj_r, 0.0, atol=1e-5)

    def test_logdet_matches_autodiff_jacobian(self, rng):
        flow = _flow()
        x = jax.random.normal(rng, (4, 2))
        t = jnp.float32(0.5)
        params = flow.init(jax.random.PRNGKey(0), t, x, False)

        def fwd_single(xi):
            y, _ = flow.apply(params, t, xi, True)
            return y

        _, ldj = flow.apply(params, t, x, True)
        jac = jax.vmap(jax.jacfwd(fwd_single))(x)
        _, true_ldj = jnp.linalg.slogdet(jac)
        np.testing.assert_allclose(ldj, true_ldj, atol=1e-4)

    def test_hard_init_identity_at_t0(self, rng):
        flow = _flow(soft_init=0.0, embed_time_dim=0)
        x = jax.random.normal(rng, (8, 2))
        t = jnp.float32(0.0)
        params = flow.init(jax.random.PRNGKey(0), t, x, False)
        y, ldj = flow.apply(params, t, x, True)
        np.testing.assert_allclose(y, x, atol=1e-6)
        np.testing.assert_allclose(ldj, 0.0, atol=1e-6)


class TestRealNVP:
    def test_logdensity_at_identity_params_is_base(self, rng):
        mean = jnp.zeros(2)
        cov = jnp.eye(2)
        model = build_realnvp(
            lambda x: gaussian_logdensity(x, mean, cov), dim=2, soft_init=0.0,
            embed_time_dim=0,
        )
        x = jax.random.normal(rng, (8, 2))
        params = model.init(jax.random.PRNGKey(0), jnp.zeros([]), x)
        lp = model.apply(params, jnp.zeros([]), x)
        np.testing.assert_allclose(
            lp, gaussian_logdensity(x, mean, cov), atol=1e-5
        )

    def test_mle_improves_likelihood(self, rng):
        """A few hundred Adam steps on shifted-Gaussian data must improve
        mean log-likelihood."""
        import optax

        true_mean = jnp.array([1.5, -1.0])
        data = jax.random.normal(rng, (2048, 2)) * 0.5 + true_mean
        t = jnp.float32(1.0)
        model = build_realnvp(
            lambda x: gaussian_logdensity(x, jnp.zeros(2), jnp.eye(2)),
            dim=2,
            embed_time_dim=4,
            couple_mul=2,
        )
        params = model.init(jax.random.PRNGKey(0), t, data[:4])
        opt = optax.adam(5e-3)

        def loss_fn(p):
            return -jnp.mean(model.apply(p, t, data))

        @jax.jit
        def step(p, s):
            l, g = jax.value_and_grad(loss_fn)(p)
            u, s = opt.update(g, s)
            return optax.apply_updates(p, u), s, l

        s = opt.init(params)
        l0 = loss_fn(params)
        p = params
        for _ in range(300):
            p, s, l = step(p, s)
        assert float(l) < float(l0) - 0.5, (float(l0), float(l))


class TestActivations:
    @pytest.mark.parametrize(
        "act", ["relu", "tanh", "celu", "gelu", "elu", "silu", "softplus", "prelu"]
    )
    def test_every_activation_invertible(self, rng, act):
        """Full ActivationFactory parity incl. prelu (reference
        core/normalizing_flow.py:85-93): each activation must build and
        keep the flow exactly invertible."""
        flow = _flow(activation=act)
        x = jax.random.normal(rng, (8, 2))
        t = jnp.float32(0.3)
        params = flow.init(jax.random.PRNGKey(0), t, x, False)
        y, ldj_f = flow.apply(params, t, x, False)
        x_back, ldj_r = flow.apply(params, t, y, True)
        np.testing.assert_allclose(x_back, x, atol=1e-5)
        np.testing.assert_allclose(ldj_f + ldj_r, 0.0, atol=1e-5)
