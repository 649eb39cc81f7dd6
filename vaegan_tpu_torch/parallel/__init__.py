"""Data x model parallel training (counterpart of ``vaegan_tpu.parallel``): the
JAX names over ``torch.distributed`` processes, one per device
(``parallel.mesh`` says where the torch idiom differs), the process-group
bootstrap (``parallel.dist``) and ``train_data_parallel`` (``parallel.train``).
The batch is split by rows over the data axis and, with a spatial
``batch_spec``, by H over the model axis; the state is replicated except the
critic head's kernels, which tensor parallelism splits over the model axis."""

from vaegan_tpu_torch.parallel.mesh import (
    BatchSpec,
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
    "BatchSpec", "Mesh", "make_mesh", "batch_sharding", "replicated", "replicate_state",
    "shard_batch", "shard_state", "state_shardings", "make_parallel_train_step",
]
