from pde_inverse.ops.autodiff import (
    hvp,
    batched_grad,
    batched_hvp_quadform,
    batched_laplacian,
    divergence,
    hutchinson_divergence,
    pytree_l2_norm,
)
from pde_inverse.ops.gaussian import (
    gaussian_logdensity,
    gaussian_score,
    gaussian_sample,
)
from pde_inverse.ops.ou import (
    lti_moments,
    lti_moments_grid,
    symmetric_ou_moments,
    GaussianPathOracle,
)
from pde_inverse.ops.langevin import (
    kinetic_langevin_step,
    simulate_kinetic_langevin,
)
