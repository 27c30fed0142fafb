"""Data-parallel training: the process group, this rank's rows of a
global batch, and the replicated train state."""

from .distributed import (  # noqa: F401
    NullLogger,
    fetch_global,
    init_distributed,
    is_primary,
    place_global,
    process_count,
    process_index,
    rank_slice,
    shutdown,
    world_group,
)
from .mesh import padded_batch, shard_state  # noqa: F401
