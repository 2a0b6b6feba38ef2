"""Multi-device / multi-host parallelism: device meshes, sequence-block
sharding, sharded search and verification, jax.distributed bring-up
(device analog of the reference's thread layer; SURVEY.md §5)."""

from .distributed import (
    exchange_by_rank_range,
    initialize_multihost,
    multihost_merge_to_file,
    multihost_rank_array,
    multihost_rank_array_ranged,
    process_info,
)
from .sort_distributed import (
    build_bwt_sharded,
    rlo_order_sharded,
    sharded_sample_sort,
    sharded_sort,
    suffix_array_sharded,
)
from .mesh import (
    SEQ_AXIS,
    dynamic_block_search,
    make_mesh,
    sequence_shards,
    sequence_shards_weighted,
    sharded_backward_search,
    sharded_rank_array,
)

__all__ = [
    "SEQ_AXIS",
    "exchange_by_rank_range",
    "initialize_multihost",
    "multihost_merge_to_file",
    "multihost_rank_array",
    "multihost_rank_array_ranged",
    "process_info",
    "make_mesh",
    "rlo_order_sharded",
    "sharded_sample_sort",
    "sharded_sort",
    "suffix_array_sharded",
    "build_bwt_sharded",
    "sequence_shards",
    "sequence_shards_weighted",
    "dynamic_block_search",
    "sharded_backward_search",
    "sharded_rank_array",
]
