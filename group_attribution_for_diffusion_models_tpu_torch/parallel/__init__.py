from .ensemble import EnsembleTrainer, derived_seed, pad_member_indices  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh,
    gather_members,
    make_mesh,
    member_range,
    replicate,
    shard_ensemble,
)
