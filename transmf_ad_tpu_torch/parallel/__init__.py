"""Data- and tensor-parallel training: the process groups of the
('data', 'model') mesh, this rank's rows of a global batch, and the train
state, replicated or cut into the model axis's rows."""

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
from .mesh import (  # noqa: F401
    Mesh,
    full_optimizer_state,
    full_state_dict,
    load_state_dict,
    make_hybrid_mesh,
    make_mesh,
    padded_batch,
    param_shardings,
    shard_model,
    shard_state,
)
from .tensor import ModelAxis, Shard, shard_of  # noqa: F401
