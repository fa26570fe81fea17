"""Unit tests for the math ops layer (autodiff, gaussian, OU oracles)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_inverse.ops import (
    autodiff as ad,
    gaussian as gops,
    ou,
)


def _random_spd(key, d, scale=1.0):
    a = jax.random.normal(key, (d, d + 1))
    return a @ a.T * scale / d + 0.1 * jnp.eye(d)


class TestAutodiff:
    def test_hvp_quadratic(self, rng):
        d = 5
        A = _random_spd(rng, d)
        f = lambda x: 0.5 * x @ A @ x
        x = jax.random.normal(jax.random.fold_in(rng, 1), (d,))
        v = jax.random.normal(jax.random.fold_in(rng, 2), (d,))
        np.testing.assert_allclose(ad.hvp(f, x, v), A @ v, rtol=1e-5)
        np.testing.assert_allclose(ad.vhv(f, x, v), v @ A @ v, rtol=1e-5)

    def test_batched_grad_multi_axis(self, rng):
        f = lambda x: jnp.sum(jnp.sin(x))
        x = jax.random.normal(rng, (3, 4, 2, 6))
        np.testing.assert_allclose(ad.batched_grad(f, x), jnp.cos(x), rtol=1e-6)

    def test_fused_grad_hvp_matches_separate(self, rng):
        """The fused one-pass variants must agree with the separate
        batched sweeps they replace in the weak-form losses."""
        f = lambda x: jnp.sum(jnp.sin(x)) + 0.5 * jnp.sum(x**2) * x[0]
        x = jax.random.normal(rng, (9, 5))
        v = jax.random.normal(jax.random.fold_in(rng, 1), (9, 5))
        g, q = ad.batched_grad_and_hvp_quadform(f, x, v)
        np.testing.assert_allclose(g, ad.batched_grad(f, x), rtol=1e-6)
        np.testing.assert_allclose(
            q, ad.batched_hvp_quadform(f, x, v), rtol=1e-5
        )
        val, g3, q3 = ad.batched_value_grad_hvp_quadform(f, x, v)
        np.testing.assert_allclose(val, ad.batched_value(f, x), rtol=1e-6)
        np.testing.assert_allclose(g3, g, rtol=1e-6)
        np.testing.assert_allclose(q3, q, rtol=1e-5)

    def test_batched_laplacian_matches_trace_hessian(self, rng):
        d = 4
        f = lambda x: jnp.sum(x**3) + jnp.prod(x)
        x = jax.random.normal(rng, (7, d))
        expected = jax.vmap(lambda xi: jnp.trace(jax.hessian(f)(xi)))(x)
        np.testing.assert_allclose(ad.batched_laplacian(f, x), expected, rtol=1e-5)

    def test_divergence_exact(self, rng):
        d = 3
        W = jax.random.normal(rng, (d, d))
        f = lambda x: W @ x
        x = jax.random.normal(jax.random.fold_in(rng, 3), (5, d))
        np.testing.assert_allclose(
            ad.divergence(f, x), jnp.full(5, jnp.trace(W)), rtol=2e-3
        )

    def test_hutchinson_divergence_unbiased(self, rng):
        d = 4
        W = jax.random.normal(rng, (d, d))
        f = lambda x: W @ x
        x = jnp.ones(d)
        probes = jax.random.rademacher(
            jax.random.fold_in(rng, 1), (4096, d), dtype=jnp.float32
        )
        est = ad.hutchinson_divergence(f, x, probes)
        np.testing.assert_allclose(est, jnp.trace(W), rtol=0.15)

    def test_pytree_norm(self):
        tree = {"a": jnp.array([3.0]), "b": jnp.array([4.0])}
        np.testing.assert_allclose(ad.pytree_l2_norm(tree), 5.0)


class TestGaussianOps:
    def test_logdensity_matches_scipy_formula(self, rng):
        d = 4
        cov = _random_spd(rng, d)
        mean = jax.random.normal(jax.random.fold_in(rng, 1), (d,))
        x = jax.random.normal(jax.random.fold_in(rng, 2), (10, d))
        expected = -0.5 * (
            d * jnp.log(2 * jnp.pi)
            + jnp.log(jnp.linalg.det(cov))
            + jnp.einsum("ni,ij,nj->n", x - mean, jnp.linalg.inv(cov), x - mean)
        )
        np.testing.assert_allclose(
            gops.gaussian_logdensity(x, mean, cov), expected, rtol=1e-4
        )

    def test_score_is_grad_of_logdensity(self, rng):
        d = 3
        cov = _random_spd(rng, d)
        mean = jnp.arange(d, dtype=jnp.float32)
        x = jax.random.normal(jax.random.fold_in(rng, 1), (6, d))
        autodiff_score = jax.vmap(
            jax.grad(lambda xi: gops.gaussian_logdensity(xi, mean, cov))
        )(x)
        np.testing.assert_allclose(
            gops.gaussian_score(x, mean, cov), autodiff_score, rtol=1e-4, atol=1e-5
        )

    def test_sample_moments(self, rng):
        d = 3
        cov = _random_spd(rng, d)
        mean = jnp.array([1.0, -2.0, 0.5])
        chol = jnp.linalg.cholesky(cov)
        x = gops.gaussian_sample(rng, mean, chol, 200_000)
        np.testing.assert_allclose(x.mean(0), mean, atol=0.02)
        emp_cov = jnp.cov(x.T)
        np.testing.assert_allclose(emp_cov, cov, atol=0.05)

    def test_mixture_score_matches_autodiff(self, rng):
        k, d = 3, 2
        means = jax.random.normal(rng, (k, d)) * 2
        covs = jnp.stack([_random_spd(jax.random.fold_in(rng, i), d) for i in range(k)])
        x = jax.random.normal(jax.random.fold_in(rng, 9), (5, d))
        expected = jax.vmap(
            jax.grad(lambda xi: gops.mixture_logdensity(xi, means, covs))
        )(x)
        np.testing.assert_allclose(
            gops.mixture_score(x, means, covs), expected, rtol=1e-4, atol=1e-5
        )


class TestOUOracles:
    """Gate: Van Loan expm oracle vs odeint integration of the moment ODEs
    (the reference's own self-check strategy, fokker_planck_example.py:101-116)."""

    def _kinetic_config(self, d=2, gamma=1.0):
        _F = jax.random.normal(jax.random.PRNGKey(2217), (d, d + 1))
        tilde_F = _F @ _F.T
        F = jnp.block([[jnp.zeros((d, d)), jnp.eye(d)], [-tilde_F, -gamma * jnp.eye(d)]])
        L = jnp.block(
            [[jnp.zeros((d, d)), jnp.zeros((d, d))], [jnp.zeros((d, d)), 2.0 * jnp.eye(d)]]
        )
        m0 = jnp.zeros(2 * d)
        P0 = jnp.eye(2 * d)
        return F, L, m0, P0

    def test_lti_moments_vs_odeint(self):
        from jax.experimental.ode import odeint

        F, L, m0, P0 = self._kinetic_config()
        ts = jnp.linspace(0.0, 2.0, 9)

        def ode(state, t):
            return {"m": F @ state["m"], "P": F @ state["P"] + state["P"] @ F.T + L}

        sol = odeint(ode, {"m": m0, "P": P0}, ts, atol=1e-10, rtol=1e-10)
        means, covs = ou.lti_moments_grid(F, L, m0, P0, ts)
        np.testing.assert_allclose(means, sol["m"], atol=1e-4)
        np.testing.assert_allclose(covs, sol["P"], atol=1e-4)

    def test_symmetric_ou_vs_general(self):
        d = 3
        F = _random_spd(jax.random.PRNGKey(0), d)
        L = 2.0 * jnp.eye(d)
        m0 = jnp.ones(d)
        P0 = 5.0 * jnp.eye(d)
        ts = jnp.array([0.0, 0.3, 1.0, 2.5])
        m_spec, P_spec = ou.symmetric_ou_moments(F, L, m0, P0, ts)
        m_gen, P_gen = ou.lti_moments_grid(-F, L, m0, P0, ts)
        np.testing.assert_allclose(m_spec, m_gen, atol=1e-4)
        np.testing.assert_allclose(P_spec, P_gen, atol=1e-4)

    def test_logdensity_time_derivatives_fd(self):
        """Finite-difference gate for d/ds and d2/ds2 log-density — the
        rebuild of the reference's test_partial_s_log_density.py oracle.
        Runs in float64: the f32 roundoff floor eps*|f|/delta^2 swamps the
        second-difference signal."""
        with jax.enable_x64():
            F, L, m0, P0 = self._kinetic_config(d=2)
            F, L, m0, P0 = (a.astype(jnp.float64) for a in (F, L, m0, P0))
            oracle = ou.GaussianPathOracle(A=F, L=L, m0=m0, P0=P0)
            dim = 2
            x = jax.random.normal(jax.random.PRNGKey(7), (64, dim)).astype(
                jnp.float64
            )
            s = jnp.float64(0.8)
            delta = 1e-4

            def logrho(s_):
                mean, cov = oracle.moments(s_)
                return gops.gaussian_logdensity(x, mean[:dim], cov[:dim, :dim])

            fd1 = (logrho(s + delta) - logrho(s - delta)) / (2 * delta)
            fd2 = (logrho(s + delta) - 2 * logrho(s) + logrho(s - delta)) / delta**2

            an1 = oracle.partial_s_logdensity(s, x, dim)
            an2 = oracle.partial_s2_logdensity(s, x, dim)

            rel1 = jnp.linalg.norm(an1 - fd1) / jnp.linalg.norm(fd1)
            rel2 = jnp.linalg.norm(an2 - fd2) / jnp.linalg.norm(fd2)
            assert rel1 < 1e-6, f"first derivative rel err {rel1}"
            assert rel2 < 1e-4, f"second derivative rel err {rel2}"


class TestSpectralOracle:
    """The spectral (eigendecomposition) oracle must match the Kronecker
    expm path on the kinetic drift, including under vmap/jit."""

    def _setup(self, d=2, gamma=1.0):
        _F = jax.random.normal(jax.random.PRNGKey(2217), (d, d + 1))
        tF = _F @ _F.T
        F = jnp.block(
            [[jnp.zeros((d, d)), jnp.eye(d)], [-tF, -gamma * jnp.eye(d)]]
        )
        L = jnp.block(
            [
                [jnp.zeros((d, d)), jnp.zeros((d, d))],
                [jnp.zeros((d, d)), 2.0 * jnp.eye(d)],
            ]
        )
        return F, L, jnp.zeros(2 * d), jnp.eye(2 * d)

    def test_matches_expm(self):
        F, L, m0, P0 = self._setup()
        orc = ou.GaussianPathOracle.create(F, L, m0, P0)
        assert orc.spectral is not None
        ts = jnp.array([0.05, 0.5, 1.0, 2.0])
        m_s, P_s = jax.jit(orc.moments_grid)(ts)
        m_e, P_e = ou.lti_moments_grid(F, L, m0, P0, ts)
        np.testing.assert_allclose(m_s, m_e, atol=1e-5)
        np.testing.assert_allclose(P_s, P_e, atol=1e-5)

    def test_scalar_and_fallback(self):
        F, L, m0, P0 = self._setup()
        orc_spec = ou.GaussianPathOracle.create(F, L, m0, P0)
        orc_expm = ou.GaussianPathOracle(A=F, L=L, m0=m0, P0=P0)
        assert orc_expm.spectral is None
        t = jnp.float32(0.7)
        m1, P1 = orc_spec.moments(t)
        m2, P2 = orc_expm.moments(t)
        np.testing.assert_allclose(P1, P2, atol=1e-5)
        np.testing.assert_allclose(m1, m2, atol=1e-6)

    def test_time_derivative_paths_unchanged(self):
        """partial_s log-density uses the analytic Lyapunov formulas with
        spectral moments underneath — FD gate at f32 tolerance."""
        F, L, m0, P0 = self._setup()
        orc = ou.GaussianPathOracle.create(F, L, m0, P0)
        x = jax.random.normal(jax.random.PRNGKey(3), (32, 2))
        s = jnp.float32(0.6)
        delta = 1e-2
        def logrho(s_):
            mean, cov = orc.moments(s_)
            return gops.gaussian_logdensity(x, mean[:2], cov[:2, :2])
        fd1 = (logrho(s + delta) - logrho(s - delta)) / (2 * delta)
        an1 = orc.partial_s_logdensity(s, x, 2)
        rel = jnp.linalg.norm(an1 - fd1) / jnp.linalg.norm(fd1)
        assert rel < 5e-3, rel
