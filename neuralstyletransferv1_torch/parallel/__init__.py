"""Several devices and several hosts: the device mesh (``mesh.py``: the
frame batch split across cards from one process, the temporal chain's
one-frame halo between shards) and the directory-backed per-video job
queue (``jobqueue.py``)."""

from .mesh import Mesh, make_mesh, shard_stylizer, temporal_postprocess_sharded

__all__ = ["Mesh", "make_mesh", "shard_stylizer", "temporal_postprocess_sharded"]
