from vision_basedsensor_tpu.parallel.ingest import ShardedPackedFeed
from vision_basedsensor_tpu.parallel.mesh import (
    collective_ops_in_hlo,
    make_mesh,
    make_sharded_pipeline,
    shard_frames,
)

__all__ = ["ShardedPackedFeed", "collective_ops_in_hlo", "make_mesh",
           "make_sharded_pipeline", "shard_frames"]
