"""pde_inverse — a JAX framework for PDE inverse problems.

Recovers unknown coefficients of Fokker-Planck-type PDEs (the potential V(x)
of a (kinetic) Fokker-Planck equation, or the interaction kernel Phi(x) of a
kinetic McKean-Vlasov equation) from sampled trajectory data, using
consistency-based weak-form residual losses evaluated with JAX autodiff.

Capability parity target: shenzebang/PDE-inverse-problem (see SURVEY.md).
Architecture: single fused jitted train steps, GSPMD sharding over a
`jax.sharding.Mesh`, closed-form matrix-exponential moment oracles (no
odeint inside the step).
"""

__version__ = "0.1.0"

from pde_inverse import config as config
