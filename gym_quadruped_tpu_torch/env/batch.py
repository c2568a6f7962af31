"""Batched stepping with NaN quarantine, and stepping with a sensor fired
every few steps.

Counterpart of gym_quadruped_tpu/env/batch.py. A diverged env (a non-finite
or exploded state from an extreme contact configuration) must not poison the
batch: after each step such envs are found and replaced by freshly reset
ones.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import tree_map

from gym_quadruped_tpu_torch.env.state import EnvState

# |qvel| beyond this counts as diverged even when finite: contact resolution
# at 500 Hz never gives joint speeds of km/s in a valid state.
QVEL_EXPLODED = 1e6


def bad_state_mask(state: EnvState) -> torch.Tensor:
    """(B,) bool: envs whose state is non-finite or exploded."""
    qp_ok = torch.isfinite(state.qpos).all(-1)
    qv = state.qvel
    qv_ok = (torch.isfinite(qv) & (qv.abs() < QVEL_EXPLODED)).all(-1)
    return ~(qp_ok & qv_ok)


def _put(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    out = dst.clone()
    out[idx] = src
    return out


def _merge(dst, idx: torch.Tensor, src):
    """The dataclass `dst` (an EnvState or a sensor state) with rows idx of
    every tensor replaced by `src`'s, the sensor states' too."""
    return dataclasses.replace(dst, **{
        f.name: (tuple(_merge(d, idx, s) for d, s in zip(dst.sensors, src.sensors))
                 if f.name == 'sensors' else _put(getattr(dst, f.name), idx, getattr(src, f.name)))
        for f in dataclasses.fields(dst)})


def quarantine_step(env, state: EnvState, action, generator: torch.Generator):
    """`env.step` with NaN quarantine: (state', obs, reward, terminated,
    truncated, info), where diverged envs are re-initialised by `env.reset`
    from fresh draws of `generator`, reported terminated and counted in
    info['quarantined'] (a tensor).

    The reference skips the reset with a `lax.cond` inside its program. Here
    the step syncs with the host once (whether any env diverged); only when
    one did, `env.reset` runs for those envs alone (its lift loop syncs twice
    per round) and they are written into the batch by index, their sensor
    states with them."""
    state2, obs, reward, term, trunc, info = env.step(state, action, generator)
    bad = bad_state_mask(state2)
    info = dict(info)
    info['quarantined'] = bad.sum(dtype=torch.int32)
    if bool(bad.any()):
        idx = bad.nonzero()[:, 0]
        fresh, fresh_obs = env.reset(generator, idx.numel())
        state2 = _merge(state2, idx, fresh)
        obs = {k: _put(v, idx, fresh_obs[k]) for k, v in obs.items()}
    return state2, obs, reward, term | bad, trunc, info


def rollout_with_sensors(step_fn, state, actions, sensor_fn, steps_per_chunk: int):
    """Step `step_fn` over `actions`, firing `sensor_fn` once every
    `steps_per_chunk` steps: the batched cadence for expensive sensors
    (cameras), as the reference's chunked scan.

    Args:
      step_fn: `(state, action) -> (state, *rest)`, a batched step (e.g.
        `env.step`); only the first output is carried.
      state: the initial batched state.
      actions: `(T, ...)` actions; T must be a multiple of `steps_per_chunk`.
      sensor_fn: `(state) -> tensor or pytree of tensors`, the readout fired
        after each chunk.
      steps_per_chunk: steps between two firings.

    Returns:
      `(final_state, sensor_seq)`, `sensor_seq` being `sensor_fn`'s outputs
      stacked over the `T // steps_per_chunk` chunk ends.
    """
    n_steps = actions.shape[0]
    if n_steps % steps_per_chunk != 0:
        raise ValueError(f'actions length {n_steps} not a multiple of '
                         f'steps_per_chunk={steps_per_chunk}')
    readouts = []
    for t, a in enumerate(actions):
        state = step_fn(state, a)[0]
        if (t + 1) % steps_per_chunk == 0:
            readouts.append(sensor_fn(state))
    return state, tree_map(lambda *xs: torch.stack(xs), *readouts)
