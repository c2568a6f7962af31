"""The env batch split over ranks.

Counterpart of gym_quadruped_tpu/parallel/mesh.py. The reference shards
the batch axis of one jitted program over a (dcn=hosts, ici=chips) device
mesh. Here each rank of torch.distributed (one process per device) steps
its own B / world envs on its own device with the same batched
`QuadrupedEnv`: the batch axis is embarrassingly parallel, so the step
needs no communication, and collectives appear only in reductions
(`distributed.all_hosts_sum`, `MPPI.solve_sharded`).

    mesh = make_mesh()                       # every rank of the job
    reset, step = shard_env(env, mesh)       # env built on mesh.device
    state, obs = reset(generator, 4096)      # this rank's 4096 / world envs
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as tdist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The job's ranks laid out as (hosts, local devices), one device per
    rank, and this rank's place in it."""

    ranks: np.ndarray                  # (n_hosts, per_host) global ranks
    axis_names: tuple
    rank: int                          # this process's rank
    device: torch.device               # this rank's device

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)


def rank_device(rank: int) -> torch.device:
    """The device of a rank: `cuda:<rank % device count>` where CUDA is
    available, else the CPU."""
    if torch.cuda.is_available():
        return torch.device('cuda', rank % torch.cuda.device_count())
    return torch.device('cpu')


def make_mesh(device=None, axis_names=('dcn', 'ici')) -> Mesh:
    """The mesh of every rank of the job as (hosts, ranks per host): a
    single process is (1, 1); under torch.distributed the ranks per host are
    `LOCAL_WORLD_SIZE` (as torchrun sets it), else every rank on one host.
    To use fewer devices, launch fewer ranks. `device` is this rank's
    (`rank_device` by default)."""
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    rank = tdist.get_rank() if tdist.is_initialized() else 0
    per_host = min(int(os.environ.get('LOCAL_WORLD_SIZE', world)), world)
    if world % per_host:
        raise ValueError(f'{world} ranks do not fill hosts of {per_host}')
    device = torch.device(device) if device is not None else rank_device(rank)
    return Mesh(np.arange(world).reshape(world // per_host, per_host), tuple(axis_names), rank,
                device)


def batch_spec(mesh: Mesh) -> tuple:
    """The mesh axes that the leading (env-batch) axis is split over: all."""
    return tuple(mesh.axis_names)


def _indexed(device) -> torch.device:
    """The device with its index: 'cuda' is the current card."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


def _rows(x, mesh: Mesh, n: int, what: str):
    """x, the rank's own n rows, on the rank's device."""
    x = torch.as_tensor(x, device=mesh.device)
    if x.shape[0] != n:
        raise ValueError(f'{what} has {x.shape[0]} rows, this rank holds {n} envs: pass the '
                         f"rank's own rows (`distributed.batch_sharding`)")
    return x


def shard_env(env, mesh: Mesh):
    """(reset_fn, step_fn) of `env` (built on `mesh.device`) with the env
    batch split over the mesh's ranks. Every tensor passed in holds this
    rank's rows only (`distributed.batch_sharding` names them).

    reset_fn(generator, B, qpos=None, qvel=None, options=None): this
    rank's B / world envs of a batch of B; qpos (B / world, nq) and qvel
    (B / world, nv) when given. The draws come from `generator`, which each
    rank seeds for itself.
    step_fn(state, action, generator=None): one step of this rank's envs,
    `action` (B / world, nu).
    B must be divisible by the mesh's size.
    """
    if _indexed(env.model.device) != _indexed(mesh.device):
        raise ValueError(f'the env lies on {env.model.device}, this rank on {mesh.device}')

    def reset_fn(generator, B, qpos=None, qvel=None, options=None):
        if B % mesh.size:
            raise ValueError(f'a batch of {B} envs does not split over {mesh.size} ranks')
        n = B // mesh.size
        qpos = None if qpos is None else _rows(qpos, mesh, n, 'qpos')
        qvel = None if qvel is None else _rows(qvel, mesh, n, 'qvel')
        return env.reset(generator, n, qpos=qpos, qvel=qvel, options=options)

    def step_fn(state, action, generator=None):
        return env.step(state, _rows(action, mesh, state.qpos.shape[0], 'action'), generator)

    return reset_fn, step_fn


def rollout(env, steps: int, step_fn=None):
    """run(state, actions, generator=None) -> (final state, obs, rewards,
    terminations): `steps` env steps of a (B, T, nu) plan with zero-order
    hold past its end, through `step_fn` (`env.step` by default, or a
    `shard_env` step); obs, rewards and terminations stacked over the
    steps on a leading axis, (steps, B, ...), as the reference's scan
    stacks them."""
    step_fn = step_fn or env.step

    def run(state, actions, generator=None):
        obs, rewards, terms = [], [], []
        for t in range(steps):
            state, o, r, term, _, _ = step_fn(state, actions[:, min(t, actions.shape[1] - 1)],
                                              generator)
            obs.append(o)
            rewards.append(r)
            terms.append(term)
        stacked = {k: torch.stack([o[k] for o in obs]) for k in obs[0]}
        return state, stacked, torch.stack(rewards), torch.stack(terms)

    return run
