"""Multi-GPU scaling over a torch.distributed device mesh (counterpart of
``cosmax/parallel``): walker sharding, the data-sharded chi^2, the sharded
flagship log-prob and the spawn helper that starts a process group."""

from cosmax_torch.parallel.flagship import build_sharded_log_prob, build_sharded_value_and_grad
from cosmax_torch.parallel.launch import spawn
from cosmax_torch.parallel.mesh import (
    data_sharded_chi2,
    gather_walkers,
    make_mesh,
    make_multislice_mesh,
    mesh_device,
    shard_walkers,
    sharded_batched_log_prob,
    walker_axes,
)

__all__ = [
    "build_sharded_log_prob",
    "build_sharded_value_and_grad",
    "data_sharded_chi2",
    "gather_walkers",
    "make_mesh",
    "make_multislice_mesh",
    "mesh_device",
    "shard_walkers",
    "sharded_batched_log_prob",
    "spawn",
    "walker_axes",
]
