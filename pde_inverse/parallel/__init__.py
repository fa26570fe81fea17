from pde_inverse.parallel.mesh import (
    MeshSpec,
    build_mesh,
    shard_batch,
    replicate,
)
