"""Sharded (gop × tile) video coding: the port of ``ivclab_tpu.parallel``.

The JAX package's ``frame_sharding``/``plane_sharding`` (``NamedSharding``
specs) have no counterpart: :func:`shard_frames` cuts the frames itself.
"""

from ivclab_tpu_torch.parallel.halo import (
    exchange_row_halo,
    motion_compensate_tile,
    motion_search_tile,
)
from ivclab_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from ivclab_tpu_torch.parallel.video import (
    ShardedAdaptiveEncoder,
    ShardedGopStreams,
    assemble_video_payloads,
    build_sharded_video_codec,
    build_sharded_video_encoder,
    shard_frames,
)

__all__ = [
    "Mesh", "make_mesh", "init_distributed",
    "exchange_row_halo", "motion_search_tile", "motion_compensate_tile",
    "ShardedAdaptiveEncoder", "ShardedGopStreams", "assemble_video_payloads",
    "build_sharded_video_codec", "build_sharded_video_encoder", "shard_frames",
]
