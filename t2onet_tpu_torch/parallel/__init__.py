"""Devices and data parallelism (counterpart of `t2onet_tpu.parallel`):
`mesh` holds the `Mesh` that the sharded chain, serving and the planner
split their batches over, and the data-parallel group the trainers
join; `workers` starts rank processes without torchrun; `dryrun` is the
multi-device dry run."""

from t2onet_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_data_parallel,
    make_mesh,
    rank,
    rows_of,
    shard_batch,
    world_size,
)
