"""The distributed layer on ``torch.distributed`` (counterpart of
psgd_torch_tpu/parallel): meshes, partition maps, the drift check and the
state placements (``mesh``), the per-shard optimizers over DTensor
parameters (``sharded``), the one-declaration layout (``recipe``) and the
tensor-parallel forward's collectives (``tensor_parallel``).  The
stack-sharded (ZeRO-style) and factor-sharded preconditioners are the
``stack_sharding`` and ``factor_sharding`` options of ``optim.KronWhiten``
and ``optim.KronNewton``; the row-sharded LRA and dense ones the
``vector_sharding`` option of ``optim.LRAWhiten``, ``optim.LRANewton`` and
``optim.DenseNewton``."""

from .mesh import (LayerReshard, MeshAxes, RowReduce, ShardGroup,
                   all_gather_stack, dense_state_specs, drift_check,
                   gather_whole, gpt2_partition_specs, llama_partition_specs,
                   lra_state_specs, make_mesh, make_multihost_mesh,
                   psgd_state_specs, shard_group)
from .recipe import ShardingRecipe, sharding_recipe
from .sharded import (PerShardKronNewton, PerShardKronWhiten,
                      per_shard_kron_newton, per_shard_kron_whiten)

__all__ = ["LayerReshard", "MeshAxes", "PerShardKronNewton",
           "PerShardKronWhiten", "RowReduce", "ShardGroup", "ShardingRecipe",
           "all_gather_stack", "dense_state_specs", "drift_check",
           "gather_whole", "gpt2_partition_specs", "llama_partition_specs",
           "lra_state_specs", "make_mesh", "make_multihost_mesh",
           "per_shard_kron_newton", "per_shard_kron_whiten",
           "psgd_state_specs", "shard_group", "sharding_recipe"]
