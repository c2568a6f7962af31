"""The port's aliengo/flat step against the JAX package's batched step, in
f64: B=4 `step_batched` against the reference's jitted
`engine.step_batched`, which takes the batch-trailing narrow phase and
`make_efc_bt`: the culled slots (`pyr_sel`) exactly, and qpos, qvel, qacc
and the simple-row forces within 1e-6, since the vmapped and per-env
reference programs already differ at ~1e-9 and the Newton solve amplifies
it (as for spot/flat and go2/flat).
"""

import numpy as np
import torch

from gym_quadruped_tpu.physics import engine as jeng
from gym_quadruped_tpu_torch.physics import engine as peng
from test_torch_mixed import fast_jit
from test_torch_step import _close, _contact_state
from test_torch_step_pyramidal import _one_thread, robot_of  # noqa: F401


def test_batch_matches_vmapped_step_batched(robot_of):  # noqa: F811
    jm, dm, _ = robot_of('aliengo')
    B = 4
    qpos, qvel, ctrl = _contact_state(jm, B, seed=31)
    warm = np.zeros_like(qvel)
    rq, rv, rfwd = fast_jit(lambda q, v, c, w: jeng.step_batched(jm, q, v, c, warmstart=w))(
        qpos, qvel, ctrl, warm)
    q, v, fwd = peng.step_batched(dm, *(torch.as_tensor(x) for x in (qpos, qvel, ctrl, warm)))
    assert bool(fwd.efc.active[:, 20:].any())
    np.testing.assert_array_equal(fwd.efc.pyr_sel.numpy(), np.asarray(rfwd.efc.pyr_sel))
    for name, got, ref in [('qpos', q, rq), ('qvel', v, rv), ('qacc', fwd.qacc, rfwd.qacc),
                           ('efc_force', fwd.efc_force, rfwd.efc_force)]:
        _close(got, np.asarray(ref), 1e-6, name)
