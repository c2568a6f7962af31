"""The multi-process runtime on torch.distributed.

Counterpart of gym_quadruped_tpu/parallel/distributed.py. Each process
(rank) drives one device: the card `cuda:<rank % device count>` where
CUDA is available, else the CPU. `initialize()` brings up the process group
(nccl on the card, gloo on the CPU) from its arguments or the environment
(`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`, `RANK`); a single process with
nothing configured is a no-op. `global_mesh()` lays the ranks out as
(hosts, local devices) under the reference's axis names.

PyTorch has no global array: every rank holds its own slice of the env
batch as ordinary tensors on its device, and what spans ranks goes through
collectives (`all_hosts_sum`, the MPPI reductions). `batch_sharding` names
the slice of a global batch that a rank holds, `host_local_batch` moves a
rank's slice to its device.

    from gym_quadruped_tpu_torch.parallel import distributed as dist
    dist.initialize()                # no-op in a single process
    mesh = dist.global_mesh()        # (hosts, local devices)
    local = dist.host_local_batch(mesh, per_rank_arrays)
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import numpy as np
import torch
import torch.distributed as tdist

from gym_quadruped_tpu_torch.parallel.mesh import Mesh, make_mesh
from gym_quadruped_tpu_torch.utils.tree import map_with_path


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None) -> None:
    """Bring up the process group (idempotent). `coordinator_address` is
    'host:port' (else `MASTER_ADDR` and `MASTER_PORT`), `num_processes` the
    world size (else `WORLD_SIZE`), `process_id` this rank (else `RANK`);
    `backend` nccl where CUDA is available, else gloo. With no address and
    no world size configured it does nothing: a single-process run. On the
    card each rank then uses `cuda:<rank % device count>`."""
    if tdist.is_initialized():
        return
    if coordinator_address is None and 'MASTER_ADDR' in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and 'WORLD_SIZE' in os.environ:
        num_processes = int(os.environ['WORLD_SIZE'])
    if process_id is None:
        process_id = int(os.environ.get('RANK', 0))
    if coordinator_address is None and num_processes is None:
        return  # a single process
    if coordinator_address is None or num_processes is None:
        raise ValueError('initialize needs both the coordinator address and the number of '
                         'processes (arguments or MASTER_ADDR and WORLD_SIZE)')
    backend = backend or ('nccl' if torch.cuda.is_available() else 'gloo')
    if backend == 'nccl':
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    tdist.init_process_group(backend, init_method=f'tcp://{coordinator_address}',
                             world_size=num_processes, rank=process_id)


def world_size() -> int:
    """The number of ranks: 1 without a process group."""
    return tdist.get_world_size() if tdist.is_initialized() else 1


def rank() -> int:
    """This process's rank: 0 without a process group."""
    return tdist.get_rank() if tdist.is_initialized() else 0


def global_mesh(axis_names=('dcn', 'ici')) -> Mesh:
    """The (hosts, local devices) mesh over every rank of the job."""
    return make_mesh(axis_names=axis_names)


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """The slice of a global env batch of `batch` envs that this rank holds:
    the leading axis split evenly over every rank of the mesh, in rank
    order."""
    if batch % mesh.size:
        raise ValueError(f'a batch of {batch} envs does not split over {mesh.size} ranks')
    n = batch // mesh.size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def host_local_batch(mesh: Mesh, local_tree):
    """This rank's slice of the batch (numpy arrays or tensors in dicts,
    lists, tuples and dataclasses), on the rank's device. There is no global
    array to assemble: each rank keeps its slice (see the module
    docstring)."""
    if isinstance(local_tree, np.ndarray):
        return torch.as_tensor(local_tree, device=mesh.device)
    if isinstance(local_tree, Mapping):
        return {k: host_local_batch(mesh, v) for k, v in local_tree.items()}
    if isinstance(local_tree, (list, tuple)):
        return type(local_tree)(host_local_batch(mesh, v) for v in local_tree)
    return map_with_path(lambda _, x: x.to(mesh.device), local_tree)


def all_hosts_sum(x) -> float:
    """The sum of a scalar over every rank (metrics); the identity in a
    single process."""
    if world_size() == 1:
        return float(np.asarray(x))
    device = 'cuda' if tdist.get_backend() == 'nccl' else 'cpu'
    t = torch.tensor(float(np.asarray(x)), dtype=torch.float64, device=device)
    tdist.all_reduce(t, tdist.ReduceOp.SUM)
    return float(t)
