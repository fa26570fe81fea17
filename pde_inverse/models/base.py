"""Plain-JAX module base: ``init(rng, *x) -> variables``, ``apply(variables, *x)``.

A model is a frozen dataclass of hyperparameters with one ``forward(vars,
*x)`` method that reads its parameters through ``vars.param(name, init,
*args)`` and its submodules through ``vars.child(name)``.  At ``init`` the
same method runs once and creates each parameter; at ``apply`` it reads
them back.  Variables are ``{"params": tree}``, with the tree laid out and
keyed as the earlier Flax linen modules laid it out (``Dense_k/{kernel,
bias}`` ...), and every parameter drawn from the key linen would have drawn
it from (the SHA-1 fold of the module path and the per-scope parameter
counter into the root key).  Checkpoints written by those modules restore
into these unchanged, and a seed initializes the same weights.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, Tuple

import jax
import jax.numpy as jnp


def _fold_in_path(rng: jax.Array, path: Tuple[Any, ...]) -> jax.Array:
    """Fold a static (names..., counter) path into ``rng``: the first four
    bytes of the SHA-1 of the concatenated encodings, as one uint32."""
    if not path:
        return rng
    h = hashlib.sha1()
    for item in path:
        if isinstance(item, str):
            h.update(item.encode("utf-8"))
        else:
            h.update(item.to_bytes((item.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(
        rng, jnp.uint32(int.from_bytes(h.digest()[:4], "big"))
    )


class Vars:
    """Parameter scope: creates parameters at init (``rng`` given), reads
    them at apply (``rng`` None)."""

    def __init__(self, tree: Dict[str, Any], rng=None, path=()):
        self.tree = tree
        self.rng = rng
        self.path = path
        self._count = 0

    def param(self, name: str, init_fn: Callable, *args):
        if self.rng is None:
            return self.tree[name]
        self._count += 1
        value = init_fn(_fold_in_path(self.rng, self.path + (self._count,)), *args)
        self.tree[name] = value
        return value

    def child(self, name: str) -> "Vars":
        if self.rng is None:
            return Vars(self.tree.get(name, {}))
        sub = self.tree.setdefault(name, {})
        return Vars(sub, self.rng, self.path + (name,))


def dense(
    v: Vars,
    x: jnp.ndarray,
    features: int,
    kernel_init: Callable = jax.nn.initializers.lecun_normal(),
    dtype=None,
) -> jnp.ndarray:
    """Affine layer ``x @ kernel + bias`` with float32 parameters; inputs and
    parameters are cast to ``dtype`` (or their common type) first."""
    kernel = v.param("kernel", kernel_init, (x.shape[-1], features), jnp.float32)
    bias = v.param("bias", jax.nn.initializers.zeros, (features,), jnp.float32)
    dtype = dtype or jnp.result_type(x, kernel)
    x, kernel, bias = (a.astype(dtype) for a in (x, kernel, bias))
    y = jax.lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
    return y + bias.reshape((1,) * (y.ndim - 1) + (-1,))


class Module:
    """Mixin for frozen-dataclass models defining ``forward(vars, *x)``."""

    def forward(self, v: Vars, *args, **kwargs):
        raise NotImplementedError

    def init(self, rng: jax.Array, *args, **kwargs) -> Dict[str, Any]:
        tree: Dict[str, Any] = {}
        self.forward(Vars(tree, rng), *args, **kwargs)
        return {"params": tree}

    def apply(self, variables: Dict[str, Any], *args, **kwargs):
        return self.forward(Vars(variables["params"]), *args, **kwargs)

    def __call__(self, v: Vars, *args, **kwargs):
        return self.forward(v, *args, **kwargs)
