"""The port's physics step on the robots of the per-slot contact rows and
the mesh colliders against the JAX package's `engine.step` under vmap, in
f64: one `step_batched` of 2 contact states (the keyframe pressed up to 3
cm into the floor, joints and velocities perturbed, seeded torques) at a
Newton cap of 30 (converged: two programs of one state stopped at the cap
of 10 differ by up to 1e-5), within 1e-9 of 1 + max|reference|, on
mini_cheetah/flat (pyramidal, mixed condims: ns 402, the mesh groups);
hyqreal1/flat (elliptic, the mesh groups) is in test_torch_step_hyqreal1.py
and go1/flat (ns 443, its condim-1 rows beside the cone blocks) in
test_torch_step_go1.py, one reference program per file.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import engine as jeng
from gym_quadruped_tpu_torch.models.model import from_arrays, to_device
from gym_quadruped_tpu_torch.physics import engine as peng
from test_torch_mixed import fast_jit
from test_torch_step import _close, _contact_state

CAP = 30
NS = {'go1': 443, 'mini_cheetah': 402, 'hyqreal1': 24}


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh_robot(robot):
    """(reference model, port model in f64, the reference's step vmapped and
    jitted at the cap of 30)."""
    jm = jload(robot, 'flat')
    dm = to_device(from_arrays({f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)}),
                   'cpu', torch.float64)
    jstep = fast_jit(jax.vmap(lambda q, v, c, w: jeng.step(jm, q, v, c, warmstart=w,
                                                         solver_iterations=CAP)))
    return jm, dm, jstep


def check_one_step(jm, dm, jstep, B=2, seed=31):
    qpos, qvel, ctrl = _contact_state(jm, B, seed=seed)
    warm = np.zeros((B, jm.nv))
    rq, rv, rfwd = jstep(qpos, qvel, ctrl, warm)
    q, v, fwd = peng.step_batched(dm, *(torch.as_tensor(x) for x in (qpos, qvel, ctrl, warm)),
                                  solver_iterations=CAP)
    assert fwd.efc.J.shape[1] == NS[jm.robot]
    assert bool(fwd.efc.active[:, fwd.efc.J.shape[1] - 1:].any() | fwd.efc.con_active.any() |
                fwd.efc.active[:, 24:].any()), 'no contact row is active'
    for name, got, ref in [('qpos', q, rq), ('qvel', v, rv), ('qacc', fwd.qacc, rfwd.qacc),
                           ('qfrc_constraint', fwd.qfrc_constraint, rfwd.qfrc_constraint),
                           ('efc_force', fwd.efc_force, rfwd.efc_force),
                           ('contacts', fwd.contacts.feat[:, 0], rfwd.contacts.feat[:, 0])]:
        _close(got, np.asarray(ref), 1e-9, f'{jm.robot} {name}')


def test_one_step_matches_reference():
    check_one_step(*mesh_robot('mini_cheetah'))
