"""Device-mesh parallelism: shard the doc batch across devices."""

from .mesh import (  # noqa: F401
    DocMesh,
    doc_mesh,
    shard_meshes,
    sharded_apply_plan,
    sharded_batch_step,
    sharded_state_vectors,
)
