"""Data-parallel training over ``torch.distributed`` ranks: the port's
counterpart of the JAX package's ``parallel/`` (its data axis)."""

from .mesh import (
    DataParallelGroup,
    entity_range,
    local_batch,
    pad_rows_for_group,
    replicate,
    row_range,
    shard_batch,
    shard_entity_blocks,
    shard_fixed_effect_dataset,
    shard_random_effect_dataset,
)
from .multihost import (
    equal_host_share,
    fully_replicate,
    host_row_range,
    initialize,
    process_count,
    process_index,
    shutdown,
    spawn,
)

__all__ = [
    "DataParallelGroup",
    "entity_range",
    "equal_host_share",
    "fully_replicate",
    "host_row_range",
    "initialize",
    "local_batch",
    "pad_rows_for_group",
    "process_count",
    "process_index",
    "replicate",
    "row_range",
    "shard_batch",
    "shard_entity_blocks",
    "shard_fixed_effect_dataset",
    "shard_random_effect_dataset",
    "shutdown",
    "spawn",
]
