"""Scale-out over processes: one device per rank, the env batch and MPPI's
samples split over the ranks, reduced with torch.distributed collectives."""

from gym_quadruped_tpu_torch.parallel import distributed
from gym_quadruped_tpu_torch.parallel.mesh import Mesh, batch_spec, make_mesh, rollout, shard_env

__all__ = ['Mesh', 'make_mesh', 'batch_spec', 'shard_env', 'rollout', 'distributed']
