"""Data parallelism across processes (port of ``featurenet_tpu/parallel/``):
the mesh record, the host feed's shards and the collectives of a
data-parallel step over ``torch.distributed`` (``mesh.py``)."""

from featurenet_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    MeshDevice,
    clamp_model_axis,
    feed_shards,
    make_mesh,
    mesh_summary,
    rank_world,
    row_block,
    train_mesh,
)
