"""Data-parallel and node-sharded execution over torch.distributed (port of
gaot3d_tpu/parallel)."""
from .mesh import DATA_AXIS, NODE_AXIS, Mesh, initialize_distributed, make_mesh
from .sharding import (Placement, active_placement, all_reduce_sum, gather_rows,
                       make_sharded_eval_step, make_sharded_train_step, placed,
                       shard_point_batch)

__all__ = ["DATA_AXIS", "NODE_AXIS", "Mesh", "initialize_distributed", "make_mesh",
           "Placement", "active_placement", "all_reduce_sum", "gather_rows",
           "make_sharded_eval_step", "make_sharded_train_step", "placed",
           "shard_point_batch"]
