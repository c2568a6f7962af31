"""The port's smooth dynamics against the JAX package's, in f64.

fk (every Kin field), cdof, mass_matrix, rne_bias, passive_force and
actuator_force at seeded random states of spot/flat and go2/flat, to 1e-9:
both sides compute the same f64 quantities, with sums taken in another order
(the port's tree recursions are products with static masks), so they agree to
rounding.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import dynamics as jdyn
from gym_quadruped_tpu.physics import kinematics as jkin
from gym_quadruped_tpu_torch.models.model import from_arrays, to_device
from gym_quadruped_tpu_torch.physics import dynamics as pdyn
from gym_quadruped_tpu_torch.physics import kinematics as pkin

TOL = 1e-9
B = 4


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(jm):
    return to_device(from_arrays({f.name: getattr(jm, f.name)
                                  for f in dataclasses.fields(jm)}),
                     'cpu', torch.float64)


def _state(jm, seed):
    """Keyframe with a random base pose, joint offsets, velocities and
    torques; env 0's torques exceed the control range."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(jm.key_qpos[0], (B, 1))
    qpos[:, :3] += rng.uniform(-0.5, 0.5, (B, 3))
    quat = rng.randn(B, 4)
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 7:] += rng.uniform(-0.4, 0.4, (B, jm.nq - 7))
    qvel = rng.randn(B, jm.nv)
    ctrl = rng.uniform(-2, 2, (B, jm.nu))
    ctrl[0] = 3 * np.asarray(jm.actuator_ctrlrange[:, 1]) * np.sign(rng.randn(jm.nu))
    return qpos, qvel, ctrl


def _smooth_ref(jm):
    def f(qpos, qvel, ctrl):
        kin = jkin.fk(jm, qpos)
        cd = jkin.cdof(jm, kin)
        return (kin, cd, jdyn.mass_matrix(jm, kin, cd),
                jdyn.rne_bias(jm, kin, qvel, cd),
                jdyn.passive_force(jm, qpos, qvel), jdyn.actuator_force(jm, ctrl))
    return jax.jit(jax.vmap(f))


def _smooth_port(dm, qpos, qvel, ctrl):
    qpos, qvel, ctrl = (torch.as_tensor(x) for x in (qpos, qvel, ctrl))
    kin = pkin.fk(dm, qpos)
    cd = pkin.cdof(dm, kin)
    return (kin, cd, pdyn.mass_matrix(dm, kin, cd), pdyn.rne_bias(dm, kin, qvel, cd),
            pdyn.passive_force(dm, qpos, qvel), pdyn.actuator_force(dm, ctrl))


def _close(port, ref, name):
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape, name
    scale = 1 + np.abs(ref).max(initial=0)
    np.testing.assert_allclose(port, ref, rtol=0, atol=TOL * scale, err_msg=name)


@pytest.mark.parametrize('robot', ['spot', 'go2'])
def test_smooth_dynamics_match(robot):
    jm = jload(robot, 'flat')
    dm = _port(jm)
    qpos, qvel, ctrl = _state(jm, seed=len(robot))
    jkin_, jcd, jM, jbias, jpas, jact = _smooth_ref(jm)(qpos, qvel, ctrl)
    kin, cd, M, bias, pas, act = _smooth_port(dm, qpos, qvel, ctrl)
    for f in dataclasses.fields(kin):
        _close(getattr(kin, f.name), getattr(jkin_, f.name), f.name)
    for name, p, r in [('cdof', cd, jcd), ('M', M, jM), ('bias', bias, jbias),
                       ('passive', pas, jpas), ('actuator', act, jact)]:
        _close(p, r, name)
    # env 0's torques were clamped to the control range
    gear = np.asarray(jm.actuator_gear)
    dofs = jm.jnt_dofadr[jm.actuator_trnid]
    assert np.allclose(np.abs(act[0, dofs].numpy()),
                       np.abs(jm.actuator_ctrlrange[:, 1] * gear))


def test_force_range_and_springs_match():
    """Branches the shipped models never take: a force range tighter than
    the control range, and hinge springs."""
    base = jload('spot', 'flat')
    jm = dataclasses.replace(
        base,
        actuator_forcelimited=np.ones(base.nu, bool),
        actuator_forcerange=np.tile([-1.5, 1.0], (base.nu, 1)),
        jnt_stiffness=np.where(base.jnt_type == 3, 20.0, 0.0))
    dm = _port(jm)
    qpos, qvel, ctrl = _state(jm, seed=7)
    _, _, _, _, jpas, jact = _smooth_ref(jm)(qpos, qvel, ctrl)
    _, _, _, _, pas, act = _smooth_port(dm, qpos, qvel, ctrl)
    _close(pas, jpas, 'passive')
    _close(act, jact, 'actuator')
    dofs = jm.jnt_dofadr[jm.actuator_trnid]
    assert act[:, dofs].max() <= 1.0 and act[:, dofs].min() >= -1.5


def test_unported_joint_types_raise():
    """Only a joint type that is none of MuJoCo's four raises. spot with its
    hinges made slide joints (sprung, so that the slide springs act too) now
    matches the reference (the joint tree of tests/test_torch_joint_tree.py
    holds ball joints and bodies with two joints)."""
    base = jload('spot', 'flat')
    jm = dataclasses.replace(base, jnt_type=np.where(base.jnt_type == 3, 2, base.jnt_type),
                             jnt_stiffness=np.where(base.jnt_type == 3, 20.0, 0.0))
    qpos, qvel, ctrl = _state(jm, seed=9)
    jkin_, jcd, jM, jbias, jpas, _ = _smooth_ref(jm)(qpos, qvel, ctrl)
    kin, cd, M, bias, pas, _ = _smooth_port(_port(jm), qpos, qvel, ctrl)
    for f in dataclasses.fields(kin):
        _close(getattr(kin, f.name), getattr(jkin_, f.name), f.name)
    for name, p, r in [('cdof', cd, jcd), ('M', M, jM), ('bias', bias, jbias),
                       ('passive', pas, jpas)]:
        _close(p, r, name)
    bad = _port(dataclasses.replace(base, jnt_type=np.where(base.jnt_type == 3, 4, base.jnt_type)))
    with pytest.raises(NotImplementedError, match='joint types'):
        pkin.fk(bad, torch.as_tensor(np.tile(base.key_qpos[0], (1, 1))))
