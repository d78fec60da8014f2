from multiple_object_tracking_lidar_tpu_torch.parallel.sharding import (
    ShardedTracker,
    make_mesh,
)

__all__ = ["make_mesh", "ShardedTracker"]
