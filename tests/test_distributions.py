"""Tests for distribution and potential primitives."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_inverse.distributions import (
    BallUniform,
    Gaussian,
    GaussianMixture,
    KineticProduct,
    Uniform,
    UniformMixture,
    box_boundary_uniforms,
)
from pde_inverse.potentials import GMMPotential, QuadraticPotential, VoidPotential


def _spd(key, d):
    a = jax.random.normal(key, (d, d + 1))
    return a @ a.T / d + 0.2 * jnp.eye(d)


class TestGaussian:
    def test_sample_and_logdensity_under_jit(self, rng):
        d = 4
        g = Gaussian.create(jnp.zeros(d), _spd(rng, d))

        @jax.jit
        def f(key):
            x = g.sample(100_000, key)
            return x.mean(0), g.logdensity(x[:5])

        mean, logp = f(rng)
        np.testing.assert_allclose(mean, jnp.zeros(d), atol=0.03)
        assert logp.shape == (5,)

    def test_score(self, rng):
        d = 3
        cov = _spd(rng, d)
        g = Gaussian.create(jnp.ones(d), cov)
        x = jax.random.normal(jax.random.fold_in(rng, 1), (7, d))
        expected = jax.vmap(jax.grad(lambda xi: g.logdensity(xi)))(x)
        np.testing.assert_allclose(g.score(x), expected, rtol=1e-4, atol=1e-5)

    def test_is_pytree(self, rng):
        g = Gaussian.create(jnp.zeros(2), jnp.eye(2))
        leaves = jax.tree_util.tree_leaves(g)
        assert len(leaves) == 3


class TestGaussianMixture:
    def test_moments(self, rng):
        means = jnp.array([[-3.0, 0.0], [3.0, 0.0]])
        covs = jnp.stack([jnp.eye(2), jnp.eye(2)])
        gmm = GaussianMixture.create(means, covs)
        x = gmm.sample(200_000, rng)
        np.testing.assert_allclose(x.mean(0), jnp.zeros(2), atol=0.05)
        # var along axis0 = within (1) + between (9)
        np.testing.assert_allclose(x[:, 0].var(), 10.0, rtol=0.05)

    def test_score_matches_autodiff(self, rng):
        means = jax.random.normal(rng, (3, 2)) * 2
        covs = jnp.stack([_spd(jax.random.fold_in(rng, i), 2) for i in range(3)])
        gmm = GaussianMixture.create(means, covs)
        x = jax.random.normal(jax.random.fold_in(rng, 5), (6, 2))
        expected = jax.vmap(jax.grad(lambda xi: gmm.logdensity(xi)))(x)
        np.testing.assert_allclose(gmm.score(x), expected, rtol=1e-4, atol=1e-5)

    def test_scalar_sigma_components(self, rng):
        means = jnp.zeros((2, 3))
        sigmas = jnp.array([1.0, 2.0])
        gmm = GaussianMixture.create(means, sigmas)
        assert gmm.covs.shape == (2, 3, 3)
        np.testing.assert_allclose(gmm.covs[1], 4.0 * jnp.eye(3))


class TestUniforms:
    def test_uniform_box(self, rng):
        u = Uniform.create(jnp.array([-1.0, 0.0]), jnp.array([1.0, 2.0]))
        x = u.sample(50_000, rng)
        assert (x[:, 0] >= -1).all() and (x[:, 0] <= 1).all()
        np.testing.assert_allclose(x[:, 1].mean(), 1.0, atol=0.02)

    def test_uniform_scalar_interval(self, rng):
        u = Uniform.create(jnp.float32(1e-4), jnp.float32(2.0))
        t = u.sample(1000, rng)
        assert t.shape == (1000,)
        assert (t >= 1e-4).all() and (t <= 2.0).all()

    def test_ball_uniform(self, rng):
        b = BallUniform.create(2.0, d=3)
        x = b.sample(10_000, rng)
        assert (jnp.linalg.norm(x, axis=-1) <= 2.0 + 1e-5).all()

    def test_uniform_mixture_and_boundary(self, rng):
        mins = jnp.array([0.0, 0.0])
        maxs = jnp.array([1.0, 1.0])
        faces = box_boundary_uniforms(mins, maxs)
        assert len(faces) == 4
        mix = UniformMixture(faces)
        x = mix.sample(4000, rng)
        on_boundary = (
            (jnp.abs(x[:, 0]) < 1e-6)
            | (jnp.abs(x[:, 0] - 1) < 1e-6)
            | (jnp.abs(x[:, 1]) < 1e-6)
            | (jnp.abs(x[:, 1] - 1) < 1e-6)
        )
        assert on_boundary.all()


class TestKineticProduct:
    def test_concat_and_independence(self, rng):
        gx = Gaussian.create(jnp.zeros(2), 4.0 * jnp.eye(2))
        gv = Gaussian.create(jnp.zeros(2), 0.1 * jnp.eye(2))
        kin = KineticProduct(gx, gv)
        z = kin.sample(100_000, rng)
        assert z.shape == (100_000, 4)
        np.testing.assert_allclose(z[:, :2].var(0), 4.0, rtol=0.05)
        np.testing.assert_allclose(z[:, 2:].var(0), 0.1, rtol=0.05)
        logp = kin.logdensity(z[:3])
        expected = gx.logdensity(z[:3, :2]) + gv.logdensity(z[:3, 2:])
        np.testing.assert_allclose(logp, expected, rtol=1e-5)


class TestPotentials:
    def test_quadratic_gradient(self, rng):
        d = 3
        cov = _spd(rng, d)
        pot = QuadraticPotential.create(jnp.ones(d), cov)
        x = jax.random.normal(jax.random.fold_in(rng, 1), (5, d))
        expected = jax.vmap(jax.grad(pot.value))(x)
        np.testing.assert_allclose(pot.gradient(x), expected, rtol=1e-4, atol=1e-5)

    def test_gmm_potential_gradient_matches_autodiff(self, rng):
        mus = jax.random.uniform(rng, (3, 4), minval=-4, maxval=4)
        pot = GMMPotential.create(mus, jnp.ones([]))
        x = jax.random.normal(jax.random.fold_in(rng, 1), (8, 4)) * 3
        expected = jax.vmap(jax.grad(pot.value))(x)
        np.testing.assert_allclose(pot.gradient(x), expected, rtol=1e-4, atol=1e-5)

    def test_gmm_potential_value_is_neg_logsumexp(self):
        mus = jnp.array([[0.0, 0.0], [2.0, 0.0]])
        pot = GMMPotential.create(mus, jnp.ones([]))
        x = jnp.array([1.0, 0.0])
        a = -jnp.array([1.0, 1.0]) / 2.0
        expected = -jax.scipy.special.logsumexp(a)
        np.testing.assert_allclose(pot.value(x), expected, rtol=1e-6)

    def test_void(self):
        pot = VoidPotential()
        x = jnp.ones((4, 2))
        assert (pot.gradient(x) == 0).all()
        assert pot.value(x).shape == (4,)
