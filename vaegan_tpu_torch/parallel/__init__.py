"""Data-parallel training (counterpart of ``vaegan_tpu.parallel``): the JAX
names over ``torch.distributed`` processes, one per device (``parallel.mesh``
says where the torch idiom differs), the process-group bootstrap
(``parallel.dist``) and ``train_data_parallel`` (``parallel.train``). Every
process holds the whole state: everything is replicated, and only the batch
is split; a model axis or a spatial ``batch_spec`` raises."""

from vaegan_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    make_parallel_train_step,
    replicate_state,
    replicated,
    shard_batch,
    shard_state,
    state_shardings,
)

__all__ = [
    "Mesh", "make_mesh", "batch_sharding", "replicated", "replicate_state",
    "shard_batch", "shard_state", "state_shardings", "make_parallel_train_step",
]
