"""Time-conditioned RealNVP normalizing flow for log-density estimation.

Capability parity with /root/reference/core/normalizing_flow.py
(SinusoidalEmbedding / TimeEmbedding / CouplingLayer / MNF / RealNVP), with
a batched structure:

* the whole coupling stack evaluates on a BATCH [n, d] natively (the
  reference is written per-point and double-vmapped from the trainer,
  core/log_density_estimation.py:48-53) so each coupling layer is one fused
  matmul over the batch;
* coupling layers carry an identity-at-t=0 parameterization: with
  soft_init == 0 the scale/translate are multiplied by t ("hard"), otherwise
  a learned per-dim scaling factor bounds the scale through tanh (parity:
  normalizing_flow.py:115-163).

Parameter tree: ``flow/layers_k/{scaling_factor, ConditionerMLP_0 (scale),
ConditionerMLP_1 (translate)}``; the one time embedding shared by every
layer lives under ``flow/layers_0/time_emb``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from pde_inverse.models.base import Module, Vars, dense


_ACTS = {
    "relu": jax.nn.relu,
    "tanh": jnp.tanh,
    "celu": jax.nn.celu,
    "gelu": jax.nn.gelu,
    "elu": jax.nn.elu,
    "silu": jax.nn.silu,
    "softplus": jax.nn.softplus,
    # reference ActivationFactory parity (core/normalizing_flow.py:85-93):
    # the reference's torch.nn.PReLU default is a leaky relu with a fixed
    # 0.25 negative slope (the learnable scalar stays at its init under the
    # reference's usage).
    "prelu": lambda x: jax.nn.leaky_relu(x, negative_slope=0.25),
}


def sinusoidal_embedding(t: jnp.ndarray, dim: int) -> jnp.ndarray:
    """t: scalar -> [dim] (sin half, cos half)."""
    half = dim // 2
    freq = jnp.exp(-math.log(10_000.0) / (half - 1) * jnp.arange(half))
    ang = t * freq
    return jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=-1)


def time_embedding(v: Vars, t: jnp.ndarray, dim: int, act: str) -> jnp.ndarray:
    h = sinusoidal_embedding(t, dim)
    h = _ACTS[act](dense(v.child("Dense_0"), h, dim))
    return dense(v.child("Dense_1"), h, dim)


def conditioner_mlp(
    v: Vars, h: jnp.ndarray, out_dim: int, act: str, widths: Sequence[int] = (8, 16, 16)
) -> jnp.ndarray:
    """The small scale/translate net (parity: BasicMLP 8-16-16,
    normalizing_flow.py:97-112)."""
    for k, w in enumerate(widths):
        h = _ACTS[act](dense(v.child(f"Dense_{k}"), h, w))
    return dense(v.child(f"Dense_{len(widths)}"), h, out_dim)


def coupling_layer(
    v: Vars,
    emb_vars: Vars,
    t: jnp.ndarray,
    x: jnp.ndarray,
    reverse: bool,
    mask: np.ndarray,
    soft_init: float,
    ignore_time: bool,
    act: str,
    embed_time_dim: int,
):
    """x: [..., d]; t scalar; mask 1 = coordinate kept (conditions the
    others).  Returns (y [..., d], ldj [...])."""
    d = mask.shape[0]
    mask = jnp.asarray(mask, x.dtype)
    scaling_factor = v.param("scaling_factor", jax.nn.initializers.zeros, (d,))

    h = x * mask
    if not ignore_time:
        if embed_time_dim > 0:
            emb = time_embedding(emb_vars, t, embed_time_dim, act)
            emb = jnp.broadcast_to(emb, x.shape[:-1] + emb.shape[-1:])
        else:
            emb = jnp.broadcast_to(t[None], x.shape[:-1] + (1,))
        h = jnp.concatenate([h, emb], axis=-1)

    scale = conditioner_mlp(v.child("ConditionerMLP_0"), h, d, act)
    translate = conditioner_mlp(v.child("ConditionerMLP_1"), h, d, act)

    if not ignore_time and soft_init == 0.0:
        # hard identity at t=0
        scale = t * scale
        translate = t * translate

    sf = jnp.exp(scaling_factor)
    scale = jnp.tanh(scale / sf) * sf
    scale = scale * (1.0 - mask)
    translate = translate * (1.0 - mask)

    if reverse:
        y = (x + translate) * jnp.exp(scale)
        ldj = jnp.sum(scale, axis=-1)
    else:
        y = x * jnp.exp(-scale) - translate
        ldj = -jnp.sum(scale, axis=-1)
    return y, ldj


def make_masks(dim: int, couple_mul: int, mask_type: str) -> np.ndarray:
    """Coupling masks: 'loop' drops one coordinate per layer; 'random' draws
    non-degenerate, non-repeating Bernoulli masks (parity:
    normalizing_flow.py:178-197)."""
    if mask_type == "loop":
        n_layers = dim * couple_mul
        masks = np.ones((n_layers, dim))
        for i in range(n_layers):
            masks[i, i % dim] = 0.0
        return masks
    if mask_type == "random":
        rng = np.random.RandomState(seed=888)
        masks, prev = [], np.zeros(dim, dtype=int)
        while len(masks) < couple_mul:
            m = rng.binomial(1, p=0.5, size=[dim])
            if m.sum() in (0, dim) or (m == prev).all():
                continue
            prev = m
            masks.append(m.astype(np.float64))
        return np.stack(masks)
    raise ValueError(f"unknown mask_type {mask_type!r}")


@dataclass(frozen=True)
class MaskedNormalizingFlow(Module):
    """Stack of coupling layers mapping samples at time t back to t=0
    (reverse=True) or pushing base samples forward (reverse=False)."""

    dim: int
    couple_mul: int = 4
    mask_type: str = "loop"
    soft_init: float = 1.0
    ignore_time: bool = False
    activation: str = "celu"
    embed_time_dim: int = 10

    def forward(self, v: Vars, t: jnp.ndarray, x: jnp.ndarray, reverse: bool = False):
        masks = make_masks(self.dim, self.couple_mul, self.mask_type)
        layer_vars = [v.child(f"layers_{i}") for i in range(masks.shape[0])]
        # one time embedding, shared by every layer, scoped under layers_0
        use_emb = not self.ignore_time and self.embed_time_dim > 0
        emb_vars = layer_vars[0].child("time_emb") if use_emb else None
        order = range(masks.shape[0])
        ldj = jnp.zeros(x.shape[:-1], x.dtype)
        for i in reversed(order) if reverse else order:
            x, step_ldj = coupling_layer(
                layer_vars[i],
                emb_vars,
                t,
                x,
                reverse,
                masks[i],
                self.soft_init,
                self.ignore_time,
                self.activation,
                self.embed_time_dim,
            )
            ldj = ldj + step_ldj
        return x, ldj


@dataclass(frozen=True)
class TimeConditionedLogDensity(Module):
    """log rho_t(x) = log p_0(T^{-1}_t x) + log|det J| (parity: RealNVP,
    normalizing_flow.py:223-229). Batched: t scalar, x [..., d]."""

    flow: MaskedNormalizingFlow
    log_prob_0: Callable[[jnp.ndarray], jnp.ndarray]

    def forward(self, v: Vars, t: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        x0, ldj = self.flow(v.child("flow"), t, x, reverse=True)
        return self.log_prob_0(x0) + ldj


def build_realnvp(
    log_prob_0: Callable,
    dim: int,
    embed_time_dim: int = 10,
    couple_mul: int = 4,
    mask_type: str = "loop",
    activation: str = "celu",
    soft_init: float = 1.0,
) -> TimeConditionedLogDensity:
    """(Parity: create_normalizing_flow_fn, log_density_estimation.py:103-114.)"""
    flow = MaskedNormalizingFlow(
        dim=dim,
        couple_mul=couple_mul,
        mask_type=mask_type,
        soft_init=soft_init,
        ignore_time=False,
        activation=activation,
        embed_time_dim=embed_time_dim,
    )
    return TimeConditionedLogDensity(flow=flow, log_prob_0=log_prob_0)
