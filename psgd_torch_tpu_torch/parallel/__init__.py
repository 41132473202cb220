"""The distributed layer on ``torch.distributed`` (counterpart of
psgd_torch_tpu/parallel): meshes, partition maps, the drift check
(``mesh``) and the per-shard optimizers over DTensor parameters
(``sharded``).  The stack-sharded (ZeRO-style) preconditioner is the
``stack_sharding`` option of ``optim.KronWhiten`` and ``optim.KronNewton``."""

from .mesh import (ShardGroup, all_gather_stack, drift_check,
                   gpt2_partition_specs, llama_partition_specs, make_mesh,
                   shard_group)
from .sharded import (PerShardKronNewton, PerShardKronWhiten,
                      per_shard_kron_newton, per_shard_kron_whiten)

__all__ = ["PerShardKronNewton", "PerShardKronWhiten", "ShardGroup",
           "all_gather_stack", "drift_check", "gpt2_partition_specs",
           "llama_partition_specs", "make_mesh", "per_shard_kron_newton",
           "per_shard_kron_whiten", "shard_group"]
