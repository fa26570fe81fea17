"""Worker script for the 2-process jax.distributed smoke test.

Each process contributes its local CPU devices to a global mesh through the
SAME code path a multi-host GPU job uses: ``main.maybe_init_distributed`` (env
opt-in) followed by ``parallel.mesh.build_mesh`` over the global device
set.  The psum assertion proves cross-process collectives (Gloo on CPU,
NCCL on GPUs) actually reduce over every process's shard.

Run (one line per process, same coordinator):
    PDE_INVERSE_MULTIHOST=1 PDE_INVERSE_COORDINATOR=<addr> \
    PDE_INVERSE_NUM_PROCESSES=<n> PDE_INVERSE_PROCESS_ID=<i> \
    python tests/multihost_worker.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")


def main() -> None:
    from pde_inverse.main import maybe_init_distributed

    maybe_init_distributed()

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pde_inverse.config import BackendConfig
    from pde_inverse.parallel.mesh import build_mesh

    proc_id = jax.process_index()
    n_procs = jax.process_count()
    n_local = jax.local_device_count()
    n_global = jax.device_count()
    assert n_procs == int(os.environ["PDE_INVERSE_NUM_PROCESSES"])
    assert n_global == n_procs * n_local, (n_global, n_procs, n_local)

    spec = build_mesh(BackendConfig())
    assert spec.n_data == n_global

    # global shard i holds the constant (i+1); the psum over the data axis
    # must equal sum_{i=1..n} i on every process
    per_shard = 4
    local_vals = np.concatenate(
        [
            np.full((per_shard,), proc_id * n_local + k + 1.0, np.float32)
            for k in range(n_local)
        ]
    )
    arr = jax.make_array_from_process_local_data(
        NamedSharding(spec.mesh, P("data")),
        local_vals,
        (n_global * per_shard,),
    )

    def f(x):
        return jax.lax.psum(x[:1], "data")

    out = jax.jit(
        jax.shard_map(
            f, mesh=spec.mesh, in_specs=P("data"), out_specs=P()
        ),
    )(arr)
    expected = sum(range(1, n_global + 1))
    got = float(np.asarray(out)[0])
    assert got == expected, (got, expected)
    print(f"[multihost proc {proc_id}] psum over {n_global} devices OK: {got}")


if __name__ == "__main__":
    main()
