"""PINN-style strong-form solvers for Fokker-Planck inverse problems.

The reference declares this solver in config only
(/root/reference/configurations/solver/PINN.yaml) and raises
NotImplementedError for it (registry.py:29-32); here it is functional for
both the overdamped and the kinetic families.

Overdamped (``PINN``): for dX = -grad V dt + sqrt(2) dW,
    d rho/dt = div(rho grad V) + Lap rho
divided by rho gives a pointwise residual in log-density form:
    r(t, x) = d/dt log rho
            - [ Lap V + grad V . grad log rho + Lap log rho
                + ||grad log rho||^2 ].

Kinetic (``PINNKinetic``): for the underdamped dynamics
    dx = v dt,   dv = -(grad V + gamma v) dt + sqrt(2) dW,
the kinetic FPE  d rho/dt + v . grad_x rho
    = grad_v . ((grad V + gamma v) rho) + Lap_v rho
divided by rho gives
    r(t, z) = d/dt log rho + v . grad_x log rho
            - [ grad V . grad_v log rho + gamma d + gamma v . grad_v log rho
                + Lap_v log rho + ||grad_v log rho||^2 ].

Both minimize E[r^2] over collocation points (t ~ U(1e-4, T), z ~ rho_t).
The log-density and its derivatives come from either

* the problem's exact Gaussian path oracle (closed-form d/dt log rho via
  the Lyapunov moment derivatives — ops/ou.py), or
* (overdamped) any callable log_density_fn(t, x) (e.g. a trained RealNVP
  from density/estimation.py), differentiated with autodiff.

Unlike the weak-form consistency loss, the strong form needs no
integration-by-parts boundary terms — but it does need pointwise density
knowledge, which is why the reference's weak form is the default method.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from pde_inverse.methods import Method
from pde_inverse.ops import autodiff as ad
from pde_inverse.ops import ou


class PINN(Method):
    """Strong-form residual solver. Supported for the overdamped
    Fokker-Planck instance (exact Gaussian path law)."""

    mesh_spec = None
    # Optional learned log-density (t, x[batch]) -> [batch]; when None the
    # problem's closed-form Gaussian path law is used.
    log_density_fn: Optional[Callable] = None

    def create_model_fn(self):
        from pde_inverse.models import get_model

        net = get_model(self.cfg, self.pde_instance)
        x = self.pde_instance.distribution_initial.sample(1, jax.random.PRNGKey(1))[0]
        params = net.init(jax.random.PRNGKey(11), x)
        return net, params

    # -- log-density derivatives -------------------------------------------------

    def _gaussian_logrho_terms(self, t, x):
        """(dt_logrho [n], grad_logrho [n, d], lap_logrho []) from the
        closed-form Gaussian law at scalar time t."""
        inst = self.pde_instance
        mean, cov = inst.moments(t)
        A = -inst.F  # overdamped drift: dX = -F X dt
        dm, dP = ou.lti_moment_derivatives(A, inst.configuration["L"], mean, cov)
        dt_logrho = ou.gaussian_logdensity_time_derivative(x, mean, cov, dm, dP)
        u = x - mean
        grad_logrho = -jnp.linalg.solve(cov, u[..., None])[..., 0]
        lap_logrho = -jnp.trace(jnp.linalg.inv(cov))
        return dt_logrho, grad_logrho, jnp.broadcast_to(lap_logrho, x.shape[:-1])

    def _learned_logrho_terms(self, t, x):
        fn = self.log_density_fn
        single = lambda ti, xi: fn(ti, xi[None])[0]
        dt_logrho = jax.vmap(lambda xi: jax.grad(single, argnums=0)(t, xi))(x)
        grad_logrho = jax.vmap(lambda xi: jax.grad(single, argnums=1)(t, xi))(x)
        lap_logrho = ad.batched_laplacian(lambda xi: single(t, xi), x)
        return dt_logrho, grad_logrho, lap_logrho

    # -- loss ---------------------------------------------------------------------

    def _residual(self, forward_fn, params, t, x):
        V = lambda xi: forward_fn(params, xi)[0]
        grad_V = ad.batched_grad(V, x)
        lap_V = ad.batched_laplacian(V, x)
        if self.log_density_fn is None:
            dt_lr, g_lr, lap_lr = self._gaussian_logrho_terms(t, x)
        else:
            dt_lr, g_lr, lap_lr = self._learned_logrho_terms(t, x)
        transport = lap_V + jnp.sum(grad_V * g_lr, axis=-1)
        diffusion = lap_lr + jnp.sum(g_lr * g_lr, axis=-1)
        return dt_lr - transport - diffusion

    def value_and_grad_fn(self, forward_fn, params, rng, dataset=None, step=None):
        inst = self.pde_instance
        n_t = self.cfg.solver.train.n_time_stamps
        n_x = self.cfg.solver.train.sample_per_time
        rng_t, rng_x = jax.random.split(rng)
        ts = inst.distribution_time.sample(n_t, rng_t)

        def sample_one(t, key):
            mean, cov = inst.moments(t)
            chol = jnp.linalg.cholesky(cov)
            eps = jax.random.normal(key, (n_x, inst.dim))
            return eps @ chol.T + mean

        # Collocation points drawn once for all stamps (bitwise-identical
        # keys/draws to the former inside-loss sampling) so the per-stamp
        # batch axis can carry a data-axis sharding constraint — GSPMD then
        # shards the residual/HVP work and psums the scalar means.
        xs = jax.vmap(sample_one)(ts, jax.random.split(rng_x, n_t))
        from pde_inverse.parallel.mesh import shard_stamp_batch

        xs = shard_stamp_batch(xs, self.mesh_spec)

        def loss_fn(params_):
            def one(t, x):
                r = self._residual(forward_fn, params_, t, x)
                V = lambda xi: forward_fn(params_, xi)[0]
                gap = jnp.mean(
                    jnp.sum(
                        (
                            ad.batched_grad(inst.V_true_fn, x)
                            - ad.batched_grad(V, x)
                        )
                        ** 2,
                        axis=-1,
                    )
                )
                return jnp.mean(r**2), gap

            losses, gaps = jax.vmap(one)(ts, xs)
            return jnp.mean(losses), jnp.mean(gaps)

        (loss, gap), grad = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return {
            "loss": loss,
            "grad": grad,
            "grad_norm": ad.pytree_l2_norm(grad),
            "loss ground truth": gap,
        }

    def test_fn(self, forward_fn, params, rng):
        from functools import partial

        from pde_inverse.losses import fokker_planck as fp_loss

        return fp_loss.test_fn(
            forward_fn=partial(forward_fn, params),
            pde_instance=self.pde_instance,
            rng=rng,
        )


class PINNKinetic(Method):
    """Strong-form residual solver for the kinetic Fokker-Planck instance
    (exact full phase-space Gaussian law from the problem oracle)."""

    mesh_spec = None

    def create_model_fn(self):
        from pde_inverse.models import get_model

        net = get_model(self.cfg, self.pde_instance)
        z = self.pde_instance.distribution_initial.sample(1, jax.random.PRNGKey(1))[0]
        x = jnp.split(z, 2, axis=-1)[0]
        params = net.init(jax.random.PRNGKey(11), x)
        return net, params

    def _logrho_terms(self, t, z):
        """(dt_logrho [n], grad_logrho [n, 2d], lap_v_logrho []) of the
        full phase-space Gaussian at scalar time t."""
        inst = self.pde_instance
        d = inst.dim
        mean, cov = inst.oracle.moments(t)
        c = inst.configuration
        dm, dP = ou.lti_moment_derivatives(c["F"], c["L"], mean, cov)
        dt_logrho = ou.gaussian_logdensity_time_derivative(z, mean, cov, dm, dP)
        u = z - mean
        inv_cov = jnp.linalg.inv(cov)
        grad_logrho = -u @ inv_cov  # [n, 2d] (inv_cov symmetric)
        lap_v = -jnp.trace(inv_cov[d:, d:])
        return dt_logrho, grad_logrho, lap_v

    def _residual(self, forward_fn, params, t, z):
        inst = self.pde_instance
        d = inst.dim
        gamma = inst.gamma_friction
        x, v = z[:, :d], z[:, d:]
        V = lambda xi: forward_fn(params, xi)[0]
        grad_V = ad.batched_grad(V, x)  # [n, d]

        dt_lr, g_lr, lap_v_lr = self._logrho_terms(t, z)
        gx_lr, gv_lr = g_lr[:, :d], g_lr[:, d:]
        transport = jnp.sum(v * gx_lr, axis=-1)
        collision = (
            jnp.sum(grad_V * gv_lr, axis=-1)
            + gamma * d
            + gamma * jnp.sum(v * gv_lr, axis=-1)
            + lap_v_lr
            + jnp.sum(gv_lr * gv_lr, axis=-1)
        )
        return dt_lr + transport - collision

    def value_and_grad_fn(self, forward_fn, params, rng, dataset=None, step=None):
        inst = self.pde_instance
        n_t = self.cfg.solver.train.n_time_stamps
        n_z = self.cfg.solver.train.sample_per_time
        rng_t, rng_z = jax.random.split(rng)
        ts = inst.distribution_time.sample(n_t, rng_t)

        def sample_one(t, key):
            mean, cov = inst.oracle.moments(t)
            chol = jnp.linalg.cholesky(cov)
            eps = jax.random.normal(key, (n_z, 2 * inst.dim))
            return eps @ chol.T + mean

        # Same data-axis collocation sharding as the overdamped PINN.
        zs = jax.vmap(sample_one)(ts, jax.random.split(rng_z, n_t))
        from pde_inverse.parallel.mesh import shard_stamp_batch

        zs = shard_stamp_batch(zs, self.mesh_spec)

        def loss_fn(params_):
            def one(t, z):
                r = self._residual(forward_fn, params_, t, z)
                V = lambda xi: forward_fn(params_, xi)[0]
                x = z[:, : inst.dim]
                gap = jnp.mean(
                    jnp.sum(
                        (
                            ad.batched_grad(inst.V_true_fn, x)
                            - ad.batched_grad(V, x)
                        )
                        ** 2,
                        axis=-1,
                    )
                )
                return jnp.mean(r**2), gap

            losses, gaps = jax.vmap(one)(ts, zs)
            return jnp.mean(losses), jnp.mean(gaps)

        (loss, gap), grad = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return {
            "loss": loss,
            "grad": grad,
            "grad_norm": ad.pytree_l2_norm(grad),
            "loss ground truth": gap,
        }

    def test_fn(self, forward_fn, params, rng):
        from functools import partial

        from pde_inverse.losses import kinetic_fokker_planck as kfp_loss

        return kfp_loss.test_fn(
            forward_fn=partial(forward_fn, params),
            pde_instance=self.pde_instance,
            rng=rng,
        )
