"""The port's batched stepping helpers (env/batch.py) on spot/flat in f64, as
tests/test_failure.py holds the reference's: `bad_state_mask` against the
reference's on the same states, `quarantine_step` resetting exactly the
diverged envs and leaving the others as a plain `env.step`, and
`rollout_with_sensors`' cadence against a plain loop.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gym_quadruped_tpu.env.batch import bad_state_mask as jbad
from gym_quadruped_tpu_torch.env import QuadrupedEnv
from gym_quadruped_tpu_torch.env.batch import bad_state_mask, quarantine_step, rollout_with_sensors
from gym_quadruped_tpu_torch.env.state import tensor_fields
from gym_quadruped_tpu_torch.models.model import load_model


@pytest.fixture(scope='module')
def env():
    n = torch.get_num_threads()
    torch.set_num_threads(1)   # tiny batched products are slower on many threads
    yield QuadrupedEnv('spot', state_obs_names=('qpos', 'qvel', 'contact_state'),
                       ground_friction_coeff=(0.5, 1.5),
                       model=load_model('spot', 'flat', device='cpu', dtype=torch.float64))
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def batch_state(env):
    state, _ = env.reset(torch.Generator().manual_seed(0), 4)
    return state


def test_bad_state_mask_matches_reference(batch_state):
    qpos, qvel = batch_state.qpos.clone(), batch_state.qvel.clone()
    qpos[0, 0] = float('nan')
    qvel[1, 7] = float('inf')
    qvel[2, 3] = 2e6      # finite but exploded
    state = dataclasses.replace(batch_state, qpos=qpos, qvel=qvel)
    got = bad_state_mask(state)
    assert got.tolist() == [True, True, True, False]
    ref = jbad(type('S', (), {'qpos': qpos.numpy(), 'qvel': qvel.numpy()}))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_quarantine_resets_bad_envs(env, batch_state):
    qpos, qvel = batch_state.qpos.clone(), batch_state.qvel.clone()
    qpos[0, 0] = float('nan')
    qvel[2, 4] = float('nan')
    state = dataclasses.replace(batch_state, qpos=qpos, qvel=qvel)
    action = torch.zeros(4, env.model.m.nu, dtype=torch.float64)
    gen = torch.Generator().manual_seed(1)
    state2, obs, reward, term, trunc, info = quarantine_step(env, state, action, gen)
    assert int(info['quarantined']) == 2
    assert term.tolist()[0] and term.tolist()[2]
    assert not bool(bad_state_mask(state2).any())
    assert bool(torch.isfinite(obs['qpos']).all())
    # the reset envs start again at step 0
    assert state2.step_num.tolist() == [0, 1, 0, 1]
    _close_envs(state2, obs, env.step(batch_state, action)[:2], [1, 3])


def _close_envs(state, obs, ref, envs):
    """The given envs of (state, obs) equal to those of `ref` exactly."""
    for f in tensor_fields(state):
        assert torch.equal(getattr(state, f.name)[envs], getattr(ref[0], f.name)[envs]), f.name
    for k in obs:
        assert torch.equal(obs[k][envs], ref[1][k][envs]), k


def test_quarantine_noop_when_healthy(env, batch_state):
    action = torch.zeros(4, env.model.m.nu, dtype=torch.float64)
    state2, obs, reward, term, trunc, info = quarantine_step(
        env, batch_state, action, torch.Generator().manual_seed(2))
    assert int(info['quarantined']) == 0
    plain = env.step(batch_state, action)
    _close_envs(state2, obs, plain[:2], [0, 1, 2, 3])
    assert torch.equal(term, plain[3])


def test_rollout_with_sensors_cadence(env, batch_state):
    """The sensor fires once per chunk and the carried state matches a plain
    step loop."""
    T, chunk = 6, 3
    acts = torch.rand(T, 4, env.model.m.nu, generator=torch.Generator().manual_seed(3),
                      dtype=torch.float64) * 2 - 1

    def sensor(s):
        return {'sum': s.qpos.sum(-1), 'z': s.qpos[:, 2]}   # stand-in for a camera readout

    final, seq = rollout_with_sensors(env.step, batch_state, acts, sensor, steps_per_chunk=chunk)
    assert seq['sum'].shape == (T // chunk, 4) and seq['z'].shape == (T // chunk, 4)
    s, expect = batch_state, []
    for t in range(T):
        s = env.step(s, acts[t])[0]
        if (t + 1) % chunk == 0:
            expect.append(sensor(s)['sum'])
    assert torch.equal(seq['sum'], torch.stack(expect))
    assert torch.equal(final.qpos, s.qpos)


def test_rollout_with_sensors_rejects_ragged():
    with pytest.raises(ValueError):
        rollout_with_sensors(lambda s, a: (s,), torch.zeros(3), torch.zeros(5, 1),
                             lambda s: s, steps_per_chunk=2)
