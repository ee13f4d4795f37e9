"""Data parallelism over pairs (counterpart of `parallel/`): `mesh` and
`distributed`. The JAX package's `point_sharding` is not ported yet (ROADMAP
Queue A item 9b)."""
from . import distributed, mesh  # noqa: F401
from .distributed import (  # noqa: F401
    global_mesh, host_local_to_global, init_distributed, process_shard_info)
from .mesh import (  # noqa: F401
    Mesh, data_sharding, gather_pairs, make_mesh, replicated, shard_pair_batch)
