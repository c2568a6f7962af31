"""The port's CentroidalMPC against the JAX package's, on go2/flat in f64.

Eight seeded go2/flat states (the keyframe with small noise in the pose,
joints and velocities, times across two gait cycles, forward and lateral
commands, a yaw rate): the feet and their world Jacobians come from the
port's kinematics and are fed to both packages.

* `solve` cold (30 ADMM iterations) and warm (10, from a given (U, z, y))
  against `jax.vmap(CentroidalMPC.solve)`: forces and warm start within
  1e-8 of 1 + max|reference|.
* `torques` on the first knot of the plan, with and without the swing legs'
  bias forces, against `jax.vmap(CentroidalMPC.torques)`: 1e-8; the hip
  positions the foothold starts from, 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.mpc import CentroidalMPC as JMPC
from gym_quadruped_tpu.mpc import GaitConfig as JGait
from gym_quadruped_tpu.mpc import MPCConfig as JConfig
from gym_quadruped_tpu_torch.models.model import load_model
from gym_quadruped_tpu_torch.mpc import CentroidalMPC, GaitConfig, MPCConfig
from gym_quadruped_tpu_torch.physics.constraints import _point_jacobians
from gym_quadruped_tpu_torch.physics.kinematics import cdof, fk
from test_torch_step import _close

B = 8


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def setup():
    dm = load_model('go2', 'flat', device='cpu', dtype=torch.float64)
    jm = jload('go2', 'flat')
    m = dm.m
    rng = np.random.RandomState(0)
    qpos = np.tile(m.key_qpos[0], (B, 1))
    qpos[:, 0:3] += 0.01 * rng.randn(B, 3)
    quat = qpos[:, 3:7] + 0.02 * rng.randn(B, 4)
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 7:] += 0.05 * rng.randn(B, m.nq - 7)
    qvel = 0.1 * rng.randn(B, m.nv)
    t = rng.uniform(0.0, 1.0, B)
    ref = np.zeros((B, 3))
    ref[:B // 2, 0] = rng.uniform(0.2, 0.6, B // 2)       # forward
    ref[B // 2:, 1] = rng.uniform(-0.4, 0.4, B - B // 2)  # lateral
    yaw_dot = rng.uniform(-0.3, 0.3, B)
    qp_t = torch.as_tensor(qpos)
    kin = fk(dm, qp_t)
    feet = kin.geom_xpos[:, torch.as_tensor(m.feet_geom_id)]
    jacp, _ = _point_jacobians(dm, kin, cdof(dm, kin), feet, m.feet_body_id)
    inputs = dict(qpos=qpos, qvel=qvel, feet=feet.numpy(), jac=jacp.numpy(), t=t, ref=ref,
                  yaw_dot=yaw_dot)
    port = CentroidalMPC(dm, MPCConfig(gait=GaitConfig('trot', 0.5)))
    ref_mpc = JMPC(jm, JConfig(gait=JGait('trot', 0.5)))
    return port, ref_mpc, inputs


def _port_args(x, *names):
    return [torch.as_tensor(x[n]) for n in names]


def _ref_args(x, *names):
    return [jnp.asarray(x[n]) for n in names]


@pytest.mark.parametrize('warm', [False, True], ids=['cold', 'warm'])
def test_solve_matches(setup, warm):
    port, ref_mpc, x = setup
    names = ('qpos', 'qvel', 'feet', 't', 'ref', 'yaw_dot')
    start = None
    if warm:
        rng = np.random.RandomState(1)
        start = tuple(rng.uniform(-40, 40, (B, 144)) for _ in range(3))
    forces, (U, z, y) = port.solve(*_port_args(x, *names),
                                   warmstart=None if start is None else tuple(map(torch.as_tensor, start)))
    jf, jw = jax.jit(jax.vmap(lambda *a: ref_mpc.solve(*a[:6], warmstart=a[6])))(
        *_ref_args(x, *names), None if start is None else tuple(map(jnp.asarray, start)))
    assert forces.shape == (B, 12, 4, 3)
    _close(forces, np.asarray(jf), 1e-8, 'forces')
    for got, want, name in zip((U, z, y), jw, ('U', 'z', 'y')):
        _close(got, np.asarray(want), 1e-8, name)


@pytest.mark.parametrize('bias', [False, True], ids=['plain', 'bias_legs'])
def test_torques_match(setup, bias):
    port, ref_mpc, x = setup
    grf = np.random.RandomState(2).uniform(-30, 30, (B, 4, 3))
    grf[..., 2] = np.abs(grf[..., 2]) + 20.0
    x = dict(x, grf=grf, bias=np.random.RandomState(3).randn(B, 4, 3))
    names = ('qpos', 'qvel', 'feet', 'jac', 'grf', 't', 'ref')
    tau = port.torques(*_port_args(x, *names),
                       qfrc_bias_legs=torch.as_tensor(x['bias']) if bias else None)
    if bias:
        jtau = jax.vmap(lambda *a: ref_mpc.torques(*a[:7], qfrc_bias_legs=a[7]))(
            *_ref_args(x, *names, 'bias'))
    else:
        jtau = jax.vmap(ref_mpc.torques)(*_ref_args(x, *names))
    assert tau.shape == (B, 12)
    _close(tau, np.asarray(jtau), 1e-8, 'tau')
    _close(port._hip_positions_w(torch.as_tensor(x['qpos'])),
           np.asarray(jax.vmap(ref_mpc._hip_positions_w)(jnp.asarray(x['qpos']))), 1e-12, 'hips')
