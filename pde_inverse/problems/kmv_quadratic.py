"""Kinetic McKean-Vlasov inverse problem with quadratic interaction.

For a quadratic interaction kernel Phi(x) = 1/2 x^T F~ x, the mean-field
convolution (Phi * rho_t) stays quadratic, so the ground-truth dynamics are
identical to the kinetic OU problem — the extra machinery is the analytic
first and second time-derivatives of the position-marginal log-density used
as weights in the KMV consistency loss.  Those come in closed form from the
Lyapunov moment ODE via the oracle
(``ops.ou.GaussianPathOracle.partial_s_logdensity`` / ``partial_s2_…``),
gated by finite-difference tests (tests/test_ops.py), replacing the
reference's 170-line hand-chain-rule (…quadratic.py:18-191).

Parity: /root/reference/example_problems/kinetic_mckean_vlasov_example_quadratic.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pde_inverse.models.parametric import QuadraticFormModel, recovered_quadratic_matrix
from pde_inverse.problems.kfp_ou import KineticFokkerPlanckOU


class KineticMcKeanVlasovQuadratic(KineticFokkerPlanckOU):
    # Phi_true is exactly quadratic, so the KMV loss computes the
    # ground-truth mean-field statistics from per-stamp sufficient
    # statistics (O(n), exact) even when the MODEL side runs the generic
    # pairwise reduction — halves the pairwise cost per step.
    phi_true_is_quadratic = True

    def Phi_true_fn(self, x: jnp.ndarray) -> jnp.ndarray:
        """True interaction kernel Phi(x) = 1/2 x^T F~ x at x [..., d]."""
        return 0.5 * jnp.einsum("...i,ij,...j->...", x, self.tilde_F, x)

    def partial_s_log_density_fn(self, s: jnp.ndarray, x: jnp.ndarray):
        """d/ds log rho_s(x) of the position marginal; s scalar or [t],
        x [..., d]; broadcasts s against x's leading axes."""
        fn = lambda si, xi: self.oracle.partial_s_logdensity(si, xi, self.dim)
        if jnp.ndim(s) == 0:
            return fn(s, x)
        return jax.vmap(lambda si: fn(si, x))(s)

    def partial_s2_log_density_fn(self, s: jnp.ndarray, x: jnp.ndarray):
        """d2/ds2 log rho_s(x) of the position marginal (same shapes)."""
        fn = lambda si, xi: self.oracle.partial_s2_logdensity(si, xi, self.dim)
        if jnp.ndim(s) == 0:
            return fn(s, x)
        return jax.vmap(lambda si: fn(si, x))(s)

    def create_parametric_model(self):
        return QuadraticFormModel(dim=self.dim)

    def recovered_parameter_rel_l2(self, params):
        try:
            est = recovered_quadratic_matrix(params)
        except KeyError:  # non-parametric model: no physical parameter
            return None
        return jnp.linalg.norm(est - self.tilde_F) / jnp.linalg.norm(self.tilde_F)
