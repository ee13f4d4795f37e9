"""Data and point parallelism (counterpart of `parallel/`): `mesh`,
`distributed` and `point_sharding`; `dryrun` is the multi-rank check."""
from . import distributed, mesh, point_sharding  # noqa: F401
from .distributed import (  # noqa: F401
    global_mesh, host_local_to_global, init_distributed, process_shard_info)
from .mesh import (  # noqa: F401
    Mesh, all_gather_rows, data_sharding, gather_pairs, halo_extend, make_mesh, replicated,
    shard_pair_batch, shard_points_batch)
from .point_sharding import (  # noqa: F401
    halo_sharded_egnn_forward, halo_sharded_egnn_forward_batched, halo_sharded_knn,
    halo_sharded_knn_batched, make_point_sharded_train_step, sharded_egnn_forward,
    sharded_egnn_forward_batched, sharded_knn, sharded_knn_batched)
