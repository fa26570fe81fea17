"""Device-mesh parallelism layer.

Replaces the reference's pmap-plus-host-mean data parallelism
(core/trainer.py:44-53) with GSPMD over a ``jax.sharding.Mesh``:

* axis ``data`` — particle/batch parallelism: every per-step batch is
  annotated with a NamedSharding over its leading axis; loss expectations
  become shard-local means + XLA-inserted collectives (psum), entirely
  inside one jitted program.
* axis ``ref``  — the mean-field reference axis of the KMV pairwise loss
  (our analogue of sequence parallelism; see losses/kinetic_mckean_vlasov).

The same code runs on 1 chip (trivial mesh) or a pod slice; multi-host only
needs ``jax.distributed.initialize`` before ``build_mesh``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pde_inverse.config import BackendConfig

DATA_AXIS = "data"
REF_AXIS = "ref"


@dataclass(frozen=True)
class MeshSpec:
    mesh: Mesh

    @property
    def data_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, P(DATA_AXIS))

    @property
    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    @property
    def n_data(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    @property
    def n_ref(self) -> int:
        return self.mesh.shape[REF_AXIS]


def build_mesh(
    backend: Optional[BackendConfig] = None, devices=None
) -> MeshSpec:
    """2-D mesh (data, ref) over the available devices.

    data_axis_size=0 uses every device on the data axis (ref axis = 1 unless
    configured), in default device order: the cards of one host are joined
    all to all, so no placement is preferred.
    """
    backend = backend or BackendConfig()
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    ref = max(1, backend.ref_axis_size)
    data = backend.data_axis_size or (n // ref)
    if data * ref != n:
        raise ValueError(
            f"mesh {data}x{ref} does not cover {n} devices; "
            "set backend.data_axis_size/ref_axis_size to factor the device count"
        )
    dev_array = np.asarray(devices).reshape(data, ref)
    return MeshSpec(mesh=Mesh(dev_array, (DATA_AXIS, REF_AXIS)))


def shard_batch(x: jnp.ndarray, spec: Optional[MeshSpec]) -> jnp.ndarray:
    """Constrain the leading axis of x onto the data axis (no-op if spec is
    None or x is too small to split)."""
    if spec is None or x.ndim == 0 or x.shape[0] % spec.n_data != 0:
        return x
    return jax.lax.with_sharding_constraint(x, spec.data_sharding)


def shard_tree_batches(tree, spec: Optional[MeshSpec]):
    return jax.tree_util.tree_map(lambda x: shard_batch(x, spec), tree)


def shard_stamp_batch(x: jnp.ndarray, spec: Optional[MeshSpec]) -> jnp.ndarray:
    """Constrain axis 1 of a [n_stamps, batch, ...] array onto the data
    axis (per-stamp collocation/path batches; no-op when unsplittable)."""
    if spec is None or x.ndim < 2 or x.shape[1] % spec.n_data != 0:
        return x
    parts = [None, DATA_AXIS] + [None] * (x.ndim - 2)
    return jax.lax.with_sharding_constraint(
        x, NamedSharding(spec.mesh, P(*parts))
    )


def replicate(tree, spec: Optional[MeshSpec]):
    """Pin a pytree (params/opt state) as fully replicated on the mesh."""
    if spec is None:
        return tree
    return jax.device_put(tree, spec.replicated)
