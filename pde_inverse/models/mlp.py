"""Non-parametric potential hypothesis network.

Parity target: ``V_hypothesis`` (reference core/model.py:32-62) — a tanh MLP
with Kaiming init whose output is a guaranteed-nonnegative scalar
sum-of-squares of the last feature layer.  Reference quirks fixed by design:
the hardcoded width-40 feature layer is configurable (default 128), and
there is no stray dependency on a fixed 4-dim problem configuration
(core/model.py:49).

The hidden path optionally runs in bfloat16 with float32 parameters and a
float32 output reduction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import jax
import jax.numpy as jnp

from pde_inverse.models.base import Module, Vars, dense


_ACTIVATIONS = {
    "tanh": jnp.tanh,
    "relu": jax.nn.relu,
    "gelu": jax.nn.gelu,
    "celu": jax.nn.celu,
    "elu": jax.nn.elu,
    "silu": jax.nn.silu,
    "sigmoid": jax.nn.sigmoid,
    "softplus": jax.nn.softplus,
}

_init = jax.nn.initializers


@dataclass(frozen=True)
class PotentialMLP(Module):
    """V(x) = sum_i h(x)_i^2 with h an MLP — smooth, >= 0, scalar.

    Optional random-Fourier front end (``fourier_features > 0``): the input
    is augmented with [cos(xB), sin(xB)], B ~ N(0, fourier_scale^2),
    trainable.  Plain tanh MLPs are spectrally biased toward very smooth
    functions and plateau near 1e-1 gradient rel-error on the multi-basin
    GMM potential (measured by scripts/diag_capacity.py); Fourier features
    restore the length-scale-1 detail the softmax basin boundaries need.
    """

    hidden_dims: Sequence[int]
    feature_dim: int = 128
    activation: str = "tanh"
    dtype: jnp.dtype = jnp.float32
    fourier_features: int = 0
    fourier_scale: float = 1.0
    # Learnable PSD-quadratic + linear skip term: V += 1/2 ||A x||^2 + b.x.
    # Bounded features make the sum-of-squares head's gradient vanish far
    # from the data, but confining potentials (the FP problem class —
    # e.g. the GMM potential's far field is exactly quadratic) grow
    # quadratically; the skip term restores the right extrapolation class
    # in low-density regions the weak-form loss barely constrains.
    quadratic_head: bool = False

    def forward(self, v: Vars, x: jnp.ndarray) -> jnp.ndarray:
        act = _ACTIVATIONS[self.activation]
        h = x.astype(self.dtype)
        if self.fourier_features > 0:
            B = v.param(
                "fourier_B",
                _init.normal(stddev=self.fourier_scale),
                (x.shape[-1], self.fourier_features),
                jnp.float32,
            )
            proj = h @ B.astype(self.dtype)
            h = jnp.concatenate([h, jnp.cos(proj), jnp.sin(proj)], axis=-1)
        for k, width in enumerate(self.hidden_dims):
            h = act(
                dense(v.child(f"Dense_{k}"), h, width, _init.kaiming_normal(), self.dtype)
            )
        h = dense(
            v.child(f"Dense_{len(self.hidden_dims)}"),
            h,
            self.feature_dim,
            _init.kaiming_normal(),
            self.dtype,
        )
        h = h.astype(jnp.float32)
        value = jnp.sum(h * h, axis=-1)
        if self.quadratic_head:
            d = x.shape[-1]
            A = v.param("quad_A", _init.normal(stddev=0.1), (d, d), jnp.float32)
            b = v.param("quad_b", _init.zeros, (d,), jnp.float32)
            xf = x.astype(jnp.float32)
            value = value + 0.5 * jnp.sum((xf @ A.T) ** 2, axis=-1) + xf @ b
        return value[None] if x.ndim == 1 else value


@dataclass(frozen=True)
class BilinearDebugPotential(Module):
    """Sanity-check hypothesis V(x) = x . (W x + c) — a single Dense map
    contracted against the input.

    Parity target: ``V_hypothesis_DEBUG``'s active branch (reference
    core/model.py:63-96 returns ``sum(y * F(y))`` with ``F = nn.Dense(dim)``;
    its commented-out MLP branches and fixed 4-dim ``V_true_fn`` wiring are
    dead code and intentionally dropped).  For a symmetric part of W this is
    an exact quadratic form, so on the OU/KMV-quadratic problems the debug
    net can represent the truth exactly — useful for separating estimator
    bias from hypothesis-class bias when debugging a loss.  Select with
    ``neural_network.model=bilinear-debug``.
    """

    def forward(self, v: Vars, x: jnp.ndarray) -> jnp.ndarray:
        xf = x.astype(jnp.float32)
        Fx = dense(v.child("Dense_0"), xf, x.shape[-1])
        value = jnp.sum(xf * Fx, axis=-1)
        return value[None] if x.ndim == 1 else value


@dataclass(frozen=True)
class ResNetPotential(Module):
    """Residual-block variant (the reference declares a ResNet config but
    raises NotImplementedError, core/model.py:116-118 — implemented here)."""

    hidden_dim: int
    n_blocks: int
    feature_dim: int = 128
    activation: str = "tanh"
    dtype: jnp.dtype = jnp.float32

    def forward(self, v: Vars, x: jnp.ndarray) -> jnp.ndarray:
        act = _ACTIVATIONS[self.activation]
        h = dense(v.child("Dense_0"), x.astype(self.dtype), self.hidden_dim, dtype=self.dtype)
        k = 1
        for _ in range(self.n_blocks):
            r = dense(v.child(f"Dense_{k}"), act(h), self.hidden_dim, dtype=self.dtype)
            r = dense(v.child(f"Dense_{k + 1}"), act(r), self.hidden_dim, dtype=self.dtype)
            h = h + r
            k += 2
        h = dense(v.child(f"Dense_{k}"), act(h), self.feature_dim, dtype=self.dtype)
        h = h.astype(jnp.float32)
        value = jnp.sum(h * h, axis=-1)
        return value[None] if x.ndim == 1 else value
