"""The joint tree on the random_pyramids scene: the port's step against the
JAX package's, in f64, from states standing on the pyramid.

The model is the port's fixture `models/fixtures/jointtree-random_pyramids.npz`,
which the port's `build_model` compiled from the tree's MJCF as go2's robot
file (scripts/torch_port/make_joint_tree.py): 4 axis-aligned tiers about
x = 3, and 25 contact pairs, the 4 foot spheres and the capsule tail each
against the floor and the 4 boxes (box-sphere, and box-capsule through the
CCD). Both packages load the same archive. The start states come from
`models/scene_starts.py::feature_start`, which the card's phase 80 uses too:
over the pyramid, dropped until the first slot touches, so the feet and the
tail meet the tiers' tops and edges.

The reference's physics runs as one vmapped program at B = 4 (its step at a
Newton cap of 30 with the Forward's contacts and constraint rows), compiled
at `FAST_COMPILE` through `test_torch_mixed.fast_jit`.

* One step from the starts: the contacts (`collide`: dist, pos, normal of
  every slot), the constraint rows (`make_efc`), qacc, qpos and qvel, to
  1e-9; every env touches a tier.
* 200 steps of seeded torques with the qacc warm start on both sides: qpos
  within 1e-3 at every step (the BASELINE bar), and the feet on the tiers.
"""

import jax
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.model import Model as JModel
from gym_quadruped_tpu.physics import engine as jeng
from gym_quadruped_tpu_torch.models.model import JOINT_TREE_PYRAMIDS, Model, to_device
from gym_quadruped_tpu_torch.models.scene_starts import feature_start, world_box_slots
from gym_quadruped_tpu_torch.physics import engine as peng
from gym_quadruped_tpu_torch.physics.constraints import constraint_layout
from test_torch_mixed import fast_jit
from test_torch_step import _close

TOL = 1e-9
B = 4
CAP = 30
TRAJ_STEPS = 200
TRAJ_BAR = 1e-3
EFC = ('J', 'aref', 'R', 'active', 'frictionloss', 'con_J', 'con_aref', 'con_R',
       'con_active', 'cone_mu', 'cone_dist')


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU, and
    # without autograd's bookkeeping the 200 steps take less time
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def pyramids():
    """(reference Model, port f64 model on the CPU, the reference's vmapped
    step at the cap of CAP with its Forward's contacts and rows)."""
    jm = JModel.load(JOINT_TREE_PYRAMIDS)
    dm = to_device(Model.load(JOINT_TREE_PYRAMIDS), 'cpu', torch.float64)

    def one(q, v, c, w):
        qn, vn, fwd = jeng.step(jm, q, v, c, warmstart=w, solver_iterations=CAP)
        return {'qpos_next': qn, 'qvel_next': vn, 'qacc': fwd.qacc,
                'contacts': fwd.contacts.feat,
                **{f'efc_{k}': getattr(fwd.efc, k) for k in EFC}}

    return jm, dm, fast_jit(jax.vmap(one))


def _start(dm, seed):
    """(qpos, qvel) in numpy: B envs from `feature_start`, small seeded
    velocities."""
    qpos = feature_start(dm, B, torch.Generator().manual_seed(seed)).numpy()
    return qpos, 0.1 * np.random.RandomState(seed).randn(B, dm.m.nv)


def _touching(dm, fwd, geoms=None):
    """(B,) the slots against a world box within their inclusion distance,
    per env; of the robot geoms `geoms` alone when given."""
    lay = constraint_layout(dm.m)
    on = (fwd.contacts.dist < torch.as_tensor(lay.con_incl)) & world_box_slots(dm)
    if geoms is not None:
        on &= torch.as_tensor(np.isin(lay.con_geom2, geoms))
    return on.sum(1)


def test_fixture_is_the_pyramid(pyramids):
    """The archive holds the tree on seed 10's pyramid: 4 tiers 0.107 m high
    about (3, 0), half-widths 1.40, 0.99, 0.58, 0.17 m; 25 pairs."""
    _, dm, _ = pyramids
    m = dm.m
    assert (m.robot, m.scene, m.nq, m.nv) == ('go2', 'random_pyramids', 23, 21)
    boxes = np.flatnonzero((m.geom_bodyid == 0) & (m.geom_type == 6))
    np.testing.assert_allclose(m.geom_size[boxes, 0], [1.4, 0.9916, 0.5832, 0.1748], atol=1e-4)
    np.testing.assert_allclose(2 * m.geom_size[boxes, 2], 0.1074, atol=1e-4)
    np.testing.assert_array_equal(m.geom_pos[boxes, :2], np.tile([3.0, 0.0], (4, 1)))
    assert len(m.contact_pairs) == 25
    robot = sorted({m.geom_names[g] for g in m.contact_pairs[:, 1]})
    assert robot == ['FL', 'FR', 'RL', 'RR', 'tail']


def test_one_step(pyramids):
    jm, dm, ref = pyramids
    qpos, qvel = _start(dm, seed=1)
    ctrl = np.random.RandomState(2).uniform(-2, 2, (B, jm.nu))
    warm = np.zeros((B, jm.nv))
    want = {k: np.asarray(v) for k, v in ref(qpos, qvel, ctrl, warm).items()}
    q, v, fwd = peng.step_batched(dm, *(torch.as_tensor(x) for x in (qpos, qvel, ctrl, warm)),
                                  solver_iterations=CAP)
    got = {'qpos_next': q, 'qvel_next': v, 'qacc': fwd.qacc, 'contacts': fwd.contacts.feat,
           **{f'efc_{k}': getattr(fwd.efc, k) for k in EFC}}
    for k, x in got.items():
        if x.dtype == torch.bool:
            np.testing.assert_array_equal(x.numpy(), want[k], err_msg=k)
        else:
            _close(x, want[k], TOL, k)
    assert bool(fwd.efc.con_active.any())
    touching = _touching(dm, fwd)
    assert bool((touching > 0).all()), f'an env touches no tier: {touching}'


def test_trajectory(pyramids):
    jm, dm, ref = pyramids
    qpos, qvel = _start(dm, seed=3)
    ctrls = np.random.RandomState(4).uniform(-2, 2, (TRAJ_STEPS, B, jm.nu))
    q, v = torch.as_tensor(qpos), torch.as_tensor(qvel)
    w = torch.zeros(B, jm.nv, dtype=torch.float64)
    rq, rv, rw = qpos, qvel, np.zeros((B, jm.nv))
    feet = np.asarray(dm.m.feet_geom_id)
    worst, feet_on = 0.0, 0
    for t in range(TRAJ_STEPS):
        q, v, fwd = peng.step_batched(dm, q, v, torch.as_tensor(ctrls[t]), warmstart=w,
                                      solver_iterations=CAP)
        w = fwd.qacc
        out = ref(rq, rv, ctrls[t], rw)
        rq, rv, rw = (np.asarray(out[k]) for k in ('qpos_next', 'qvel_next', 'qacc'))
        worst = max(worst, float(np.abs(q.numpy() - rq).max()))
        assert worst < TRAJ_BAR, f'step {t}: qpos apart by {worst}'
        feet_on = max(feet_on, int((_touching(dm, fwd, feet) > 0).sum()))
    assert np.isfinite(rq).all() and worst < TRAJ_BAR
    assert feet_on > 0, 'no foot touched a tier'
