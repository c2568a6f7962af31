"""The port's go2/flat narrow phase and step against the JAX package's
batched paths, which take the batch-trailing twins, in f64.

* `collide` against `collision_bt.collide_bt` (inside the reference's
  `step_batched`) on contact states, the tumbled states and the lowered
  keyframe of tests/test_torch_collision_go2.py, within the bars the
  reference holds its own two paths to (tests/test_collision_bt.py): 2e-5 in
  dist on every slot, 5e-5 in pos and normal on slots with dist < 0.01.
* B=4 `step_batched` against the reference's jitted `engine.step_batched`:
  1e-6, since the vmapped and per-env reference programs already differ at
  ~1e-9 and the Newton solve amplifies it (as for spot/flat).
"""

import zlib

import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import engine as jeng
from gym_quadruped_tpu_torch.physics import engine as peng
from test_torch_collision_go2 import _port_feat, _port_model, _states
from test_torch_mixed import fast_jit
from test_torch_step import _close, _contact_state


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def go2():
    """One call of the reference's jitted `step_batched` (its narrow phase is
    `collide_bt`) on 13 states: 4 contact states with torques, then the 8
    tumbled states and the lowered keyframe of test_torch_collision_go2.py."""
    jm = jload('go2', 'flat')
    qpos, qvel, ctrl = _contact_state(jm, 4, seed=31)
    key = np.asarray(jm.key_qpos[0]).copy()
    key[2] -= 0.02
    qpos = np.concatenate([qpos, _states(jm, 8, zlib.crc32(b'go2/flat'), 0.7), key[None]])
    qvel = np.concatenate([qvel, np.zeros((9, jm.nv))])
    ctrl = np.concatenate([ctrl, np.zeros((9, jm.nu))])
    warm = np.zeros_like(qvel)
    ref = fast_jit(lambda q, v, c, w: jeng.step_batched(jm, q, v, c, warmstart=w))(
        qpos, qvel, ctrl, warm)
    return jm, _port_model(jm), (qpos, qvel, ctrl, warm), ref


def test_collide_matches_collide_bt(go2):
    _, dm, _, (_, _, rfwd) = go2
    ref = np.asarray(rfwd.contacts.feat)
    got = _port_feat(dm, np.asarray(rfwd.kin.geom_xpos), np.asarray(rfwd.kin.geom_xmat))
    assert got.shape == ref.shape
    derr = np.abs(got[:, 0] - ref[:, 0]).max()
    near = ref[:, 0] < 0.01
    err = np.max(np.abs(got[:, 1:] - ref[:, 1:]) * near[:, None], initial=0.0)
    print(f'collide against collide_bt: dist {derr:.3e}, near-contact pos/normal {err:.3e} '
          f'on {int(near.sum())} slots')
    assert derr < 2e-5, f'dist differs by {derr}'
    assert near.any()
    assert err < 5e-5, f'near-contact pos/normal differ by {err}'


def test_batch_matches_vmapped_step_batched(go2):
    _, dm, inputs, (rq, rv, rfwd) = go2
    B = 4
    q, v, fwd = peng.step_batched(dm, *(torch.as_tensor(x[:B]) for x in inputs))
    assert bool(fwd.efc.con_active.any())
    for name, got, ref in [('qpos', q, rq), ('qvel', v, rv), ('qacc', fwd.qacc, rfwd.qacc),
                           ('f_cone', fwd.f_cone, rfwd.f_cone)]:
        _close(got, np.asarray(ref)[:B], 1e-6, name)
