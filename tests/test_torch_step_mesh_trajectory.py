"""200 steps of the port's physics on go1/flat, mini_cheetah/flat and
hyqreal1/flat against the JAX package's `engine.step` under vmap, in f64,
at B=2 from the keyframe with seeded U(-2, 2) torques and the qacc warm
start threaded, both at a Newton cap of 30: every env's qpos within 1e-3
(the BASELINE bar) at the end. Marked `slow` (the tier-1 command runs `-m
'not slow'`): ~10 min on one core, most of it the reference's steps.

    python -m pytest tests/test_torch_step_mesh_trajectory.py -q -m slow
"""

import numpy as np
import pytest
import torch

from gym_quadruped_tpu_torch.physics import engine as peng
from test_torch_step_mesh import CAP, _one_thread, mesh_robot  # noqa: F401

pytestmark = pytest.mark.slow


@pytest.mark.parametrize('robot', ['go1', 'mini_cheetah', 'hyqreal1'])
def test_trajectory_200_steps(robot):
    jm, dm, jstep = mesh_robot(robot)
    B, T = 2, 200
    ctrls = np.random.RandomState(0).uniform(-2, 2, (T, B, jm.nu))
    rq, rv, rw = np.tile(jm.key_qpos[0], (B, 1)), np.zeros((B, jm.nv)), np.zeros((B, jm.nv))
    q, v, w = (torch.as_tensor(x) for x in (rq, rv, rw))
    n_active = 0
    for t in range(T):
        rq, rv, rfwd = jstep(rq, rv, ctrls[t], rw)
        rw = rfwd.qacc
        q, v, fwd = peng.step_batched(dm, q, v, torch.as_tensor(ctrls[t]), warmstart=w,
                                      solver_iterations=CAP)
        w = fwd.qacc
        n_active += int(fwd.efc.active[:, 24:].sum() + fwd.efc.con_active.sum())
    assert n_active > 0, 'the trajectory never reached the contact path'
    assert np.isfinite(q.numpy()).all()
    err = np.abs(q.numpy() - np.asarray(rq)).max()
    print(f'{robot}/flat, {T} steps at B={B}: max |qpos diff| {err:.3e}')
    assert err < 1e-3, err
