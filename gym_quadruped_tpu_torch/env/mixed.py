"""Mixed-robot batches: several robots stepped together as one batch.

Counterpart of gym_quadruped_tpu/env/mixed.py (BASELINE config 5: a
4096-env batch of several robot models). The batch is partitioned into
groups, one homogeneous sub-batch per robot, each stepped by its own
`QuadrupedEnv` at its own batch size: no padding inside the physics, every
group keeps its contact layout, and a group's envs step exactly as the same
envs of a homogeneous batch (tests/test_torch_mixed.py). Per step each group
launches the SPD kernel twice and the Newton kernel once on the card, so a
batch of G groups launches 2G and G; `step` adds no host synchronisation to
the groups' own `env.step`.

The user-facing surface is padded to the largest dims across groups, so
that callers can treat the batch as one tensor-shaped thing:

    env = MixedQuadrupedEnv([('go2', 2048), ('aliengo', 1024),
                             ('mini_cheetah', 1024)], scene='flat')
    state, obs = env.reset(torch.Generator(device='cuda').manual_seed(0))
    state, obs, reward, term, trunc, info = env.step(state, actions)

`actions` is (B, nu_max); each env reads its first nu entries. Observations
are (B, dim_max), zero-padded; `obs_masks()` gives the valid lanes and
`robot_ids` each env's group index. The state is a tuple of the groups'
`EnvState`s, in group order. The CPU is asked for through each group's
`model=` (`models.model.load_model(..., device='cpu')`); every group must
live on one device in one dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from gym_quadruped_tpu_torch.env.env import QuadrupedEnv


def _pad_to(x: torch.Tensor, dim: int) -> torch.Tensor:
    """(G, d) zero-padded on its trailing axis to (G, dim)."""
    return x if x.shape[-1] == dim else F.pad(x, (0, dim - x.shape[-1]))


class MixedQuadrupedEnv:
    """Group-partitioned mixed-robot batch. See the module docstring."""

    def __init__(self, robots: Sequence[tuple], scene: str = 'flat',
                 state_obs_names=QuadrupedEnv._DEFAULT_OBS, **kwargs):
        """robots: (robot, count) or (robot, count, extra_kwargs) entries;
        extra_kwargs (per-group `state_obs_names`, `sensors`, `model`, ...)
        override the shared kwargs."""
        if not robots:
            raise ValueError('a mixed batch needs at least one group')
        self.groups: list[QuadrupedEnv] = []
        self.counts: list[int] = []
        for entry in robots:
            robot, count = entry[0], int(entry[1])
            extra = dict(entry[2]) if len(entry) > 2 else {}
            if count <= 0:
                raise ValueError(f'group {robot} needs a positive count, got {count}')
            self.groups.append(QuadrupedEnv(
                robot, scene=scene,
                state_obs_names=extra.pop('state_obs_names', state_obs_names),
                **{**kwargs, **extra}))
            self.counts.append(count)
        models = [e.model for e in self.groups]
        self.device, self.dtype = models[0].device, models[0].dtype
        if any(dm.device != self.device or dm.dtype != self.dtype for dm in models):
            raise ValueError('every group of a mixed batch must be on one device in one dtype, '
                             f'got {[(str(dm.device), dm.dtype) for dm in models]}')
        self.batch_size = sum(self.counts)
        self.state_obs_names = tuple(state_obs_names)

        self.nq_max = max(dm.m.nq for dm in models)
        self.nv_max = max(dm.m.nv for dm in models)
        self.nu_max = max(dm.m.nu for dm in models)
        # the observation surface is the union over groups: a group without a
        # name contributes zeros there (a camera observable only one robot has)
        self._group_dims = [e.observation_space_dims() for e in self.groups]
        names = list(self.state_obs_names)
        for gd in self._group_dims:
            names.extend(n for n in gd if n not in names)
        self.obs_names = tuple(names)
        self._obs_dims = {name: max(gd.get(name, 0) for gd in self._group_dims)
                          for name in self.obs_names}
        self.robot_ids = torch.repeat_interleave(
            torch.arange(len(self.counts), dtype=torch.int32),
            torch.tensor(self.counts)).to(self.device)

    # ------------------------------------------------------------------ masks

    def _lane_mask(self, dims, width) -> torch.Tensor:
        """(B, width) 0/1 rows: each group's first dims[g] lanes valid."""
        lanes = torch.arange(width)
        rows = [(lanes < d).to(self.dtype).expand(c, width)
                for d, c in zip(dims, self.counts)]
        return torch.cat(rows).to(self.device)

    def obs_masks(self) -> dict:
        """name -> (B, dim_max) 0/1 mask of each env's valid lanes."""
        return {name: self._lane_mask([gd.get(name, 0) for gd in self._group_dims], dmax)
                for name, dmax in self._obs_dims.items()}

    def action_masks(self) -> torch.Tensor:
        """(B, nu_max) 0/1 mask of each env's valid actuator lanes."""
        return self._lane_mask([e.model.m.nu for e in self.groups], self.nu_max)

    # ------------------------------------------------------------- reset/step

    def _split(self, x):
        """(B, ...) -> the groups' row slices (views)."""
        return torch.split(x, self.counts)

    def _merge_obs(self, per_group_obs) -> dict:
        obs = {}
        for name in self.obs_names:
            dmax = self._obs_dims[name]
            obs[name] = torch.cat([
                _pad_to(o[name], dmax) if name in o
                else torch.zeros(c, dmax, dtype=self.dtype, device=self.device)
                for o, c in zip(per_group_obs, self.counts)])
        return obs

    def reset(self, generator: torch.Generator) -> tuple:
        """(state tuple, padded obs): each group's `env.reset` of its count
        of envs, drawn from `generator` in group order."""
        states, obses = [], []
        for env, count in zip(self.groups, self.counts):
            s, o = env.reset(generator, count)
            states.append(s)
            obses.append(o)
        return tuple(states), self._merge_obs(obses)

    def step(self, state: tuple, action, generator: torch.Generator | None = None) -> tuple:
        """(state', obs, reward, terminated, truncated, info) of one step of
        every group: `state` the tuple of the groups' EnvStates, `action`
        (B, nu_max); `generator` is handed to each group's `env.step`. Each
        group's step is the profiler range `mixed/<robot>`."""
        outs = []
        for env, s, a in zip(self.groups, state, self._split(action)):
            with record_function(f'mixed/{env.robot_name}'):
                outs.append(env.step(s, a[:, :env.model.m.nu], generator))
        states, obses, rewards, terms, truncs, infos = zip(*outs)
        # every info value is per env (env/env.py), so the groups' concatenate
        info = {k: torch.cat([i[k] for i in infos]) for k in infos[0]}
        return (tuple(states), self._merge_obs(obses), torch.cat(rewards), torch.cat(terms),
                torch.cat(truncs), info)

    # ------------------------------------------------------- padded state view

    def padded_qpos(self, state: tuple) -> torch.Tensor:
        """(B, nq_max) zero-padded qpos across groups (monitoring, logging)."""
        return torch.cat([_pad_to(s.qpos, self.nq_max) for s in state])

    def padded_qvel(self, state: tuple) -> torch.Tensor:
        """(B, nv_max) zero-padded qvel across groups."""
        return torch.cat([_pad_to(s.qvel, self.nv_max) for s in state])
