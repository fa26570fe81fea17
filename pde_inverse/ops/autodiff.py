"""Autodiff building blocks for weak-form PDE residual losses.

Batched analogues of the reference's math utils
(``/root/reference/utils/common_utils.py:6-76``): Hessian-vector products via
forward-over-reverse ``jvp(grad)``, batched gradients/Laplacians, Hutchinson
and exact divergences, and pytree norms.  All batched variants take explicit
batch axes so XLA fuses them into large matmuls instead of
per-sample Python dispatch.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def hvp(f: Callable, x: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Hessian-vector product H_f(x) @ v via forward-over-reverse.

    One jvp through grad costs ~2 gradient evaluations — never materializes
    the Hessian.  (Parity: utils/common_utils.py:6-14.)
    """
    return jax.jvp(jax.grad(f), (x,), (v,))[1]


def vhv(f: Callable, x: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Quadratic form v^T H_f(x) v (scalar)."""
    return jnp.dot(v, hvp(f, x, v))


def batched_grad(f: Callable, x: jnp.ndarray) -> jnp.ndarray:
    """grad of scalar-valued f at a batch of points x: [..., d] -> [..., d].

    Supports arbitrarily many leading batch axes (the KMV loss needs
    [m, n, n_time, d]).
    """
    g = jax.grad(f)
    for _ in range(x.ndim - 1):
        g = jax.vmap(g)
    return g(x)


def batched_value(f: Callable, x: jnp.ndarray) -> jnp.ndarray:
    """Scalar f evaluated over arbitrarily many leading batch axes."""
    v = f
    for _ in range(x.ndim - 1):
        v = jax.vmap(v)
    return v(x)


def batched_hvp_quadform(f: Callable, x: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """v^T H_f(x) v over matching batches of x and v: [..., d] -> [...]."""
    q = lambda xi, vi: vhv(f, xi, vi)
    for _ in range(x.ndim - 1):
        q = jax.vmap(q)
    return q(x, v)


def batched_grad_and_hvp_quadform(
    f: Callable, x: jnp.ndarray, v: jnp.ndarray
):
    """(grad f(x) [..., d], v^T H_f(x) v [...]) in ONE forward-over-reverse
    pass: the jvp-of-grad primal output IS the gradient, so callers needing
    both (the weak-form losses use grad for the ||grad V||^2 and friction
    terms and the quadform for the Hessian term) get the gradient for free
    instead of paying a second reverse pass over the batch."""

    def one(xi, vi):
        g, hv = jax.jvp(jax.grad(f), (xi,), (vi,))
        return g, jnp.dot(vi, hv)

    for _ in range(x.ndim - 1):
        one = jax.vmap(one)
    return one(x, v)


def batched_value_grad_hvp_quadform(
    f: Callable, x: jnp.ndarray, v: jnp.ndarray
):
    """(f(x) [...], grad f(x) [..., d], v^T H_f(x) v [...]) in one
    forward-over-reverse pass over jax.value_and_grad — the pairwise KMV
    statistics need all three per pair and previously paid three separate
    batched sweeps."""

    def one(xi, vi):
        (val, g), (_, hv) = jax.jvp(jax.value_and_grad(f), (xi,), (vi,))
        return val, g, jnp.dot(vi, hv)

    for _ in range(x.ndim - 1):
        one = jax.vmap(one)
    return one(x, v)


def batched_laplacian(f: Callable, x: jnp.ndarray) -> jnp.ndarray:
    """Exact Laplacian tr(H_f(x)) at a batch of points, [n, d] -> [n].

    Computed as d forward-over-reverse HVPs against basis vectors — avoids
    materializing the full [n, d, d] Jacobian-of-gradient that the reference
    builds with ``jacfwd`` (methods/consistency_instances/fokker_planck.py:37-38)
    and lets XLA batch the d probes as one matmul.
    """
    d = x.shape[-1]
    eye = jnp.eye(d, dtype=x.dtype)

    def lap_single(xi):
        _, pushforward = jax.linearize(jax.grad(f), xi)
        return jnp.trace(jax.vmap(pushforward)(eye))

    return jax.vmap(lap_single)(x)


def divergence(f: Callable, x: jnp.ndarray) -> jnp.ndarray:
    """Exact divergence of a vector field f: R^d -> R^d at batch x [n, d]."""

    def div_single(xi):
        _, pushforward = jax.linearize(f, xi)
        basis = jnp.eye(xi.shape[-1], dtype=xi.dtype)
        return jnp.trace(jax.vmap(pushforward)(basis))

    if x.ndim == 1:
        return div_single(x)
    return jax.vmap(div_single)(x)


def hutchinson_divergence(
    f: Callable, x: jnp.ndarray, probes: jnp.ndarray
) -> jnp.ndarray:
    """Hutchinson divergence estimate E_v[v^T (partial f / partial x) v].

    probes: [k, d] random vectors (Rademacher or Gaussian).  Returns the
    probe-averaged estimate at a single point x.
    (Parity: utils/common_utils.py:17-23.)
    """

    def single(v):
        _, u = jax.jvp(f, (x,), (v,))
        return jnp.sum(u * v)

    return jax.vmap(single)(probes).mean(axis=0)


def pytree_l2_norm(tree) -> jnp.ndarray:
    """Global L2 norm over all leaves of a pytree.
    (Parity: utils/common_utils.py:74-76.)"""
    leaves = jax.tree_util.tree_leaves(tree)
    return jnp.sqrt(sum(jnp.vdot(g, g).real for g in leaves))


def pytree_rel_l2(tree_a, tree_b) -> jnp.ndarray:
    """Relative L2 distance ||a - b|| / ||b|| between two pytrees."""
    diff = jax.tree_util.tree_map(lambda a, b: a - b, tree_a, tree_b)
    return pytree_l2_norm(diff) / pytree_l2_norm(tree_b)


def volume_nd_ball(d: int) -> float:
    """Volume of the unit L2 ball in d dimensions.
    (Parity: utils/common_utils.py:67-72, via lgamma for stability.)"""
    import math

    return math.pi ** (d / 2.0) / math.gamma(d / 2.0 + 1.0)
