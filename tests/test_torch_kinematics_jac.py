"""The port's point Jacobian, cdof_dot and point Jacobian derivative
against the JAX package's, in f64.

`kinematics.point_jacobian`, `cdof_dot` and `point_jacobian_dot` (the
mj_jac and mj_jacDot counterparts behind the gym adapter's
`feet_jacobians` and `feet_jacobians_dot`) at seeded random states of go2,
aliengo and mini_cheetah (a random base pose, joint offsets and
velocities), for each foot at its geom's position and for a point off the
base body, to 1e-9. The reference's per-env functions run vmapped in one
program per robot, compiled at `FAST_COMPILE`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import kinematics as jkin
from gym_quadruped_tpu_torch.models.model import from_arrays, to_device
from gym_quadruped_tpu_torch.physics import kinematics as pkin
from test_torch_mixed import FAST_COMPILE

TOL = 1e-9
B = 4
ROBOTS = ('go2', 'aliengo', 'mini_cheetah')


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(jm, seed):
    rng = np.random.RandomState(seed)
    qpos = np.tile(jm.key_qpos[0], (B, 1))
    qpos[:, :3] += rng.uniform(-0.5, 0.5, (B, 3))
    quat = rng.randn(B, 4)
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 7:] += rng.uniform(-0.4, 0.4, (B, jm.nq - 7))
    return qpos, rng.randn(B, jm.nv), rng.uniform(-0.1, 0.1, (B, 3))


@pytest.fixture(scope='module', params=ROBOTS)
def robot(request):
    jm = jload(request.param, 'flat')
    dm = to_device(from_arrays({f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)}),
                   'cpu', torch.float64)
    qpos, qvel, offset = _state(jm, sum(map(ord, request.param)))
    bodies = [int(b) for b in jm.feet_body_id] + [1]

    def ref(qpos, qvel, offset):
        kin = jkin.fk(jm, qpos)
        cd = jkin.cdof(jm, kin)
        pts = [kin.geom_xpos[int(g)] for g in jm.feet_geom_id] + [kin.xpos[1] + offset]
        jac = jnp.stack([jkin.point_jacobian(jm, kin, cd, p, b) for p, b in zip(pts, bodies)])
        jdot = jnp.stack([jkin.point_jacobian_dot(jm, kin, cd, qvel, p, b)
                          for p, b in zip(pts, bodies)])
        return jkin.cdof_dot(jm, kin, qvel, cd), jac, jdot

    args = tuple(jnp.asarray(x) for x in (qpos, qvel, offset))
    fn = jax.jit(jax.vmap(ref)).lower(*args).compile(compiler_options=FAST_COMPILE)
    want = [np.asarray(x) for x in fn(*args)]
    return jm, dm, bodies, (qpos, qvel, offset), want


def _port_values(dm, bodies, state):
    qpos, qvel, offset = (torch.as_tensor(x) for x in state)
    kin = pkin.fk(dm, qpos)
    cd = pkin.cdof(dm, kin)
    pts = [kin.geom_xpos[:, int(g)] for g in dm.m.feet_geom_id] + [kin.xpos[:, 1] + offset]
    jac = torch.stack([pkin.point_jacobian(dm, kin, cd, p, b) for p, b in zip(pts, bodies)], 1)
    jdot = torch.stack([pkin.point_jacobian_dot(dm, kin, cd, qvel, p, b)
                        for p, b in zip(pts, bodies)], 1)
    return pkin.cdof_dot(dm, kin, qvel, cd), jac, jdot


@pytest.mark.parametrize('what', ['cdof_dot', 'point_jacobian', 'point_jacobian_dot'])
def test_matches_reference(robot, what):
    jm, dm, bodies, state, want = robot
    got = _port_values(dm, bodies, state)
    i = ('cdof_dot', 'point_jacobian', 'point_jacobian_dot').index(what)
    assert got[i].shape == want[i].shape, (got[i].shape, want[i].shape)
    np.testing.assert_allclose(got[i].numpy(), want[i], rtol=0, atol=TOL, err_msg=what)
    if what != 'cdof_dot':
        # off the chain of each point's body the columns are exactly zero
        for k, b in enumerate(bodies):
            off = pkin.ancestor_dof_mask(jm, b) == 0
            assert not got[i][:, k][..., off].any()
    else:
        # the free joint's translation dofs: fixed in the world
        assert not got[i][:, :3].any()
    assert np.abs(want[i]).max() > 0.1, 'a trivial comparison'
