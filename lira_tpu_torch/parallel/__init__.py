"""The sharded path on torch.distributed (port of lira_tpu/parallel/):
ranks and their launcher (mesh), data-parallel training (train_dp), the
sharded kNN and K-Means, and the sharded serving engine."""

from .mesh import Mesh, launch, launch_many, make_mesh
from .sharded_engine import ShardedQueryEngine, serve_rank
from .train_dp import dp_train_epoch, make_dp_train_step

__all__ = ["Mesh", "make_mesh", "launch", "launch_many", "make_dp_train_step",
           "dp_train_epoch", "ShardedQueryEngine", "serve_rank"]
