"""Random-Fourier-feature interaction kernel with exact mean-field collapse.

Non-parametric hypothesis for the KMV interaction kernel:

    Phi(y) = sum_k [ a_k cos(w_k . y) + b_k sin(w_k . y) ]
             + 1/2 ||A y||^2 + c . y                      (optional head)

with TRAINABLE frequencies w_k (init N(0, scale^2)), amplitudes (a, b),
and the PSD-quadratic + linear head that restores non-decaying growth
(random Fourier features are bounded; smooth shift-invariant kernels are
universal in this class as K grows — Rahimi & Recht's random-features
construction, used here as a *parameterized hypothesis*, not an
approximation of a fixed kernel).

Why this class suits the mean-field loss: the
pairwise argument only enters through phases w_k . (x - r), and the angle
difference identities

    cos(p - q) = cos p cos q + sin p sin q
    sin(p - q) = sin p cos q - cos p sin q

factor every mean-field expectation through per-stamp sufficient
statistics of the refs, S^c_t[k] = E_r cos(w_k . r_t) and S^s_t[k] =
E_r sin(w_k . r_t):

    E_r Phi(x - r)            =  a.(cx Sc + sx Ss) + b.(sx Sc - cx Ss) + ...
    E_r grad Phi(x - r)       =  sum_k w_k [ -a_k (sx Sc - cx Ss)
                                             + b_k (cx Sc + sx Ss) ]_k + ...
    E_r v^T Hess Phi(x - r) v = -sum_k (w_k . v)^2 [ a_k (cx Sc + sx Ss)
                                             + b_k (sx Sc - cx Ss) ]_k + ...

(cx = cos(w_k . x), sx = sin(w_k . x)).  Total cost O((n + m) K) in
K-wide matmuls instead of the O(n m) pairwise grid — the same exact
collapse the quadratic head enjoys, for a universal kernel class.  See
losses/fourier_meanfield.py; equality against the generic O(n^2) pairwise
reduction is gated by tests/test_fourier_kernel.py.

The reference has no analogue: its only non-parametric hypothesis is an
MLP driven through the full pairwise tensor
(/root/reference/core/model.py:109-131,
methods/consistency_instances/kinetic_mckean_vlasov.py:22-48).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from pde_inverse.models.base import Module, Vars

initializers = jax.nn.initializers


@dataclass(frozen=True)
class FourierKernelModel(Module):
    """Phi(y) = a.cos(y W^T) + b.sin(y W^T) [+ 1/2||A y||^2 + c.y]."""

    dim: int
    n_features: int = 256
    freq_scale: float = 1.0
    quadratic_head: bool = True
    # amplitude init std; 1/sqrt(K) keeps the initial field O(amp_scale)
    amp_scale: float = 0.1
    # Trainable frequencies let the model move mass to the scales the data
    # demands, but open a finite-sample failure mode: the weak-form loss's
    # only quadratic term E||E_r grad Phi||^2 is damped by the law's
    # characteristic function at high |w|, so amplitudes at large
    # frequencies ride sampling noise downhill without bound (observed:
    # |amps| grows linearly, gap diverges).  Decoupled weight decay tames
    # it only by collapsing the field to zero (bounded features need
    # weights ~1/scale^2 to express a growing truth); the field-space
    # Tikhonov stabilizer (solver.train.kmv_field_reg) pins the failure
    # mode without the collapse, and with it trainable frequencies are
    # the measured lever past the fixed-feature ~0.4 rel-L2 plateau:
    # 0.278 (K=256) / 0.227 (K=512) vs 0.70 for a bigger FIXED map
    # (K=1024) at the same 7x200 probe geometry — adaptivity, not
    # capacity, is what buys accuracy in this class.
    trainable_frequencies: bool = False
    # "normal": w_k ~ N(0, freq_scale^2) — every feature starts at ONE
    # length scale, so the optimizer must transport frequency mass across
    # scales itself.  "multiscale": per-feature stddev log-uniform in
    # [freq_scale/4, 4*freq_scale] — the init already spans ~a decade and
    # a half of length scales, giving the adaptive kernel low-frequency
    # features for the far tail and high-frequency ones for the bulk from
    # step 0 (a lever for the FK shared-tail bias).
    freq_init: str = "normal"

    def forward(self, v: Vars, y: jnp.ndarray) -> jnp.ndarray:
        if self.freq_init == "multiscale":

            def _ms_init(key, shape, dtype=jnp.float32):
                k_s, k_w = jax.random.split(key)
                scales = jnp.exp(
                    jax.random.uniform(
                        k_s,
                        (shape[0], 1),
                        minval=jnp.log(self.freq_scale / 4.0),
                        maxval=jnp.log(self.freq_scale * 4.0),
                    )
                )
                return scales * jax.random.normal(k_w, shape, dtype)

            omega_init = _ms_init
        elif self.freq_init == "normal":
            omega_init = initializers.normal(stddev=self.freq_scale)
        else:
            raise ValueError(
                f"unknown freq_init {self.freq_init!r} (normal|multiscale)"
            )
        omega = v.param(
            "omega", omega_init, (self.n_features, self.dim), jnp.float32
        )
        if not self.trainable_frequencies:
            omega = jax.lax.stop_gradient(omega)
        amp_std = self.amp_scale / max(1.0, self.n_features) ** 0.5
        a = v.param(
            "amp_cos", initializers.normal(stddev=amp_std),
            (self.n_features,), jnp.float32,
        )
        b = v.param(
            "amp_sin", initializers.normal(stddev=amp_std),
            (self.n_features,), jnp.float32,
        )
        phases = y @ omega.T  # [..., K]
        value = jnp.cos(phases) @ a + jnp.sin(phases) @ b
        if self.quadratic_head:
            A = v.param(
                "quad_A", initializers.normal(stddev=0.1),
                (self.dim, self.dim), jnp.float32,
            )
            c = v.param(
                "quad_b", initializers.zeros, (self.dim,), jnp.float32
            )
            yf = y.astype(jnp.float32)
            value = value + 0.5 * jnp.sum((yf @ A.T) ** 2, axis=-1) + yf @ c
        return value[None] if y.ndim == 1 else value
