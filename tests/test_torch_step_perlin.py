"""The port's batched physics step on a perlin scene against the JAX
package's per-env `engine.step`, in f64: spot/perlin, whose only
heightfield group is the sphere (its reference program compiles in well
under a minute; go2/perlin's is in `test_torch_step_go2_perlin.py`).

The keyframe starts buried in the terrain (the terrain under the base is
as high as the base), so both sides start from the keyframe lifted out of
it by the env's rule (base z raised by 1.1 x the feet's deepest
penetration until no foot slot is active), then lowered along the nearest
foot's normal until that foot presses 1 mm into it (at exactly touching,
whether that foot's slot is active would be left to rounding).
* One `step_batched` of seeded contact states (that start pressed U(0, 2)
  cm further into the terrain, joints and velocities perturbed) against
  `engine.step` per env: 1e-9 of 1 + max|reference|.
* 200 steps at B=4 from the start with seeded U(-2, 2) torques and the
  qacc warm start threaded: within 1e-3 in qpos (the BASELINE bar).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import engine as jeng
from gym_quadruped_tpu_torch.env import QuadrupedEnv
from gym_quadruped_tpu_torch.models.model import from_arrays, to_device
from gym_quadruped_tpu_torch.physics import collision as pcol
from gym_quadruped_tpu_torch.physics import engine as peng
from gym_quadruped_tpu_torch.physics import kinematics as pkin
from gym_quadruped_tpu_torch.physics.forces import feet_slot_mask


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perlin_scene(robot):
    """(reference model, port model in f64, the reference's per-env step
    compiled once, the start qpos (nq,))."""
    jm = jload(robot, 'perlin')
    dm = to_device(from_arrays({f.name: getattr(jm, f.name)
                                for f in dataclasses.fields(jm)}), 'cpu', torch.float64)
    jstep = jax.jit(lambda q, v, c, w: jeng.step(jm, q, v, c, warmstart=w))
    key = torch.as_tensor(jm.key_qpos[:1])
    lifted, _ = QuadrupedEnv(robot, scene='perlin', model=dm)._lift_until_no_contact(key)
    con = pcol.collide(dm, pkin.fk(dm, lifted))
    foot = torch.as_tensor(np.any(feet_slot_mask(dm.m) > 0, axis=0))
    i = int(torch.where(foot, con.dist[0], torch.inf).argmin())
    start = lifted[0].numpy().copy()
    start[2] -= max(0.0, float(con.dist[0, i] / con.normal[0, i, 2])) + 0.001
    assert start[2] > float(jm.key_qpos[0, 2]) + 0.1, 'the keyframe was not lifted'
    return jm, dm, jstep, start


def ref_steps(jstep, qpos, qvel, ctrl, warm):
    outs = [jstep(*x) for x in zip(qpos, qvel, ctrl, warm)]
    stack = lambda get: np.stack([np.asarray(get(o)) for o in outs])
    return (stack(lambda o: o[0]), stack(lambda o: o[1]), stack(lambda o: o[2].qacc),
            stack(lambda o: o[2].f_cone), stack(lambda o: o[2].qfrc_constraint))


def close(got, ref, tol, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    scale = 1 + np.abs(ref).max(initial=0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale, err_msg=name)


def one_step(scene, B=4, seed=21):
    jm, dm, jstep, start = scene
    rng = np.random.RandomState(seed)
    qpos = np.tile(start, (B, 1))
    qpos[:, 2] -= rng.uniform(0.0, 0.02, B)
    qpos[:, 7:] += rng.uniform(-0.1, 0.1, (B, jm.nq - 7))
    qvel = 0.5 * rng.randn(B, jm.nv)
    ctrl = rng.uniform(-2, 2, (B, jm.nu))
    warm = np.zeros((B, jm.nv))
    rq, rv, racc, rfc, rqc = ref_steps(jstep, qpos, qvel, ctrl, warm)
    q, v, fwd = peng.step_batched(dm, *(torch.as_tensor(x) for x in (qpos, qvel, ctrl, warm)))
    assert bool(fwd.efc.con_active.any()), 'no contact in the contact states'
    for name, got, ref in [('qpos', q, rq), ('qvel', v, rv), ('qacc', fwd.qacc, racc),
                           ('qfrc_constraint', fwd.qfrc_constraint, rqc)]:
        close(got, ref, 1e-9, name)
    close(fwd.f_cone, rfc, 1e-9, 'f_cone')


def trajectory(scene, B=4, T=200, tie=None):
    """T steps at B from the start against `engine.step` per env: qpos
    within 1e-3 at the end. With `tie(qpos)`, a step at which the port
    parts from the reference at once (from under 1e-9 to over 1e-7) is
    handed to `tie` with the reference's states before it; where it finds
    a rounding tie that explains the jump, the port takes the reference's
    state after the step and goes on (the steps are printed)."""
    jm, dm, jstep, start = scene
    ctrls = np.random.RandomState(0).uniform(-2, 2, (T, B, jm.nu))
    qpos = np.tile(start, (B, 1))
    rq, rv, rw = qpos, np.zeros((B, jm.nv)), np.zeros((B, jm.nv))
    q, v, w = (torch.as_tensor(x) for x in (rq, rv, rw))
    n_active, err, resynced = 0, 0.0, []
    for t in range(T):
        before = rq
        rq, rv, rw, _, _ = ref_steps(jstep, rq, rv, ctrls[t], rw)
        q, v, fwd = peng.step_batched(dm, q, v, torch.as_tensor(ctrls[t]), warmstart=w)
        w = fwd.qacc
        n_active += int(fwd.efc.con_active.sum())
        err, prev = np.abs(q.numpy() - rq).max(), err
        if tie is not None and prev < 1e-9 and err > 1e-7 and tie(before):
            resynced.append(t)
            q, v, w = (torch.as_tensor(x) for x in (rq, rv, rw))
    assert n_active > 0, 'the trajectory never reached the contact path'
    assert np.isfinite(q.numpy()).all()
    err = np.abs(q.numpy() - rq).max()
    print(f'{jm.robot}/perlin, {T} steps at B={B}: max |qpos diff| {err:.3e}; the port took the '
          f'reference\'s state after a rounding tie at steps {resynced}')
    assert err < 1e-3, err
    return resynced


@pytest.fixture(scope='module')
def spot():
    return perlin_scene('spot')


def test_one_step_matches_per_env_step(spot):
    one_step(spot)


def test_trajectory_200_steps(spot):
    trajectory(spot)
