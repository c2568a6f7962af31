"""go2 on the ramp, the slippery surfaces and the stairs: the port's step
against the JAX package's, in f64, from states on each scene's feature.

The scenes' world geometry (gym_quadruped_tpu/models/scenes.py:96-116):
the ramp is one box pitched by the quaternion (1, 0, -0.2, 0) (22.6
degrees, its +x end up); the stairs 50 boxes from x = 1.1, rising 0.05
every 0.1; the slippery scene two priority-2 boxes 1 cm high, friction 0.8
about x = 2 and 0.03 from x = 5 to 31, whose pair friction wins over the
feet's by the priority rule (`constraints.runtime_con_mu`).

The start states stand on the feature, not at the origin's keyframe
(`models/scene_starts.py::feature_start`, which the card's phases 75-77
use too): on the ramp's slope, on the flight of stairs raised with the
rise, on each slippery surface; joints +-0.05 rad off, small velocities.
Both sides run the model with its contact pairs cut to the feet's (as
tests/test_torch_env_sensors.py does): the feet against the floor and the
world boxes, so the reference's programs stay small. The reference's
per-env `engine.step` at a Newton cap of 30 compiles once per scene at
`FAST_COMPILE`, the three side by side where the cores allow.

Per scene:
* one `step_batched` call of 3 envs against the reference's per-env step:
  qpos, qvel and qacc to 1e-9;
* 20 steps of 2 envs with seeded torques, the qacc warm start on both
  sides: qpos within 1e-3 at every step;
* active slots against the world boxes: in every env at the start, and
  more than 0 at every step (else the scene holds nothing new); on
  slippery, each active foot-box slot's friction is the box's (0.8 or
  0.03), and
  `runtime_con_mu` of a randomised friction table equals the reference's.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import constraints as jcon
from gym_quadruped_tpu.physics import engine as jengine
from gym_quadruped_tpu_torch.models.model import from_arrays, to_device
from gym_quadruped_tpu_torch.models.scene_starts import feature_start, world_box_slots
from gym_quadruped_tpu_torch.physics import engine
from gym_quadruped_tpu_torch.physics.constraints import constraint_layout, runtime_con_mu
from test_torch_mixed import FAST_COMPILE

SCENES = ('ramp', 'slippery', 'stairs')
CAP = 30
TOL = 1e-9
TRAJ_STEPS = 20
TRAJ_BAR = 1e-3


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feet_model(scene):
    jm = jload('go2', scene)
    feet = set(np.asarray(jm.feet_geom_id).tolist())
    jm = dataclasses.replace(jm, contact_pairs=np.array(
        [p for p in np.asarray(jm.contact_pairs) if int(p[1]) in feet]))
    dm = to_device(from_arrays({f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)}),
                   'cpu', torch.float64)
    return jm, dm


def active_world_box(dm, fwd) -> torch.Tensor:
    """(B,) the active slots against the world boxes, per env."""
    lay = constraint_layout(dm.m)
    return ((fwd.contacts.dist < torch.as_tensor(lay.con_incl)) & world_box_slots(dm)).sum(1)


def start(dm, B, seed):
    """(qpos (B, nq), qvel (B, nv)) in numpy: B envs on the scene's feature
    (`feature_start`), small seeded velocities."""
    qpos = feature_start(dm, B, torch.Generator().manual_seed(seed)).numpy()
    return qpos, 0.1 * np.random.RandomState(seed).randn(B, dm.m.nv)


@pytest.fixture(scope='module')
def scenes():
    """{scene: (reference model, port model, the reference's per-env step
    program)}, the three programs compiled side by side."""
    models = {s: _feet_model(s) for s in SCENES}
    lowered = []
    for s in SCENES:
        jm = models[s][0]
        fn = jax.jit(lambda q, v, c, w, jm=jm: jengine.step(jm, q, v, c, warmstart=w,
                                                             solver_iterations=CAP))
        lowered.append(fn.lower(jnp.zeros(jm.nq), jnp.zeros(jm.nv), jnp.zeros(jm.nu),
                                jnp.zeros(jm.nv)))
    with ThreadPoolExecutor(min(len(SCENES), len(os.sched_getaffinity(0)))) as pool:
        programs = list(pool.map(lambda p: p.compile(compiler_options=FAST_COMPILE), lowered))
    return {s: models[s] + (p,) for s, p in zip(SCENES, programs)}


def _ref_steps(program, qpos, qvel, ctrl, warm):
    """The reference's per-env step of each env: (qpos', qvel', qacc)."""
    outs = [program(*(jnp.asarray(x[b]) for x in (qpos, qvel, ctrl, warm)))
            for b in range(qpos.shape[0])]
    return tuple(np.stack([np.asarray(o) for o in x]) for x in
                 zip(*[(o[0], o[1], o[2].qacc) for o in outs]))


@pytest.mark.parametrize('scene', SCENES)
def test_one_step(scenes, scene):
    jm, dm, program = scenes[scene]
    qpos, qvel = start(dm, 3, seed=1)
    ctrl = np.random.RandomState(2).uniform(-2, 2, (3, jm.nu))
    warm = np.zeros((3, jm.nv))
    q, v, fwd = engine.step_batched(dm, *(torch.as_tensor(x) for x in (qpos, qvel, ctrl, warm)),
                                    solver_iterations=CAP)
    want = _ref_steps(program, qpos, qvel, ctrl, warm)
    for name, got, w in zip(('qpos', 'qvel', 'qacc'), (q, v, fwd.qacc), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=TOL, err_msg=f'{scene} {name}')
    touching = active_world_box(dm, fwd)
    assert bool((touching > 0).all()), f'{scene}: an env touches no world box: {touching}'


@pytest.mark.parametrize('scene', SCENES)
def test_trajectory(scenes, scene):
    jm, dm, program = scenes[scene]
    qpos, qvel = start(dm, 2, seed=3)
    ctrls = np.random.RandomState(4).uniform(-2, 2, (TRAJ_STEPS, 2, jm.nu))
    q, v = torch.as_tensor(qpos), torch.as_tensor(qvel)
    w = torch.zeros(2, jm.nv, dtype=torch.float64)
    rq, rv, rw = qpos, qvel, np.zeros((2, jm.nv))
    worst = 0.0
    for t in range(TRAJ_STEPS):
        q, v, fwd = engine.step_batched(dm, q, v, torch.as_tensor(ctrls[t]), warmstart=w,
                                        solver_iterations=CAP)
        w = fwd.qacc
        rq, rv, rw = _ref_steps(program, rq, rv, ctrls[t], rw)
        worst = max(worst, float(np.abs(q.numpy() - rq).max()))
        assert worst < TRAJ_BAR, f'{scene}: step {t} qpos apart by {worst}'
        assert int(active_world_box(dm, fwd).sum()) > 0, f'{scene}: step {t} touches no box'
    assert np.isfinite(rq).all() and worst < TRAJ_BAR


def test_slippery_pair_friction(scenes):
    """The slippery boxes' priority wins the pair friction: each active
    foot-box slot at the start reads its box's sliding friction (0.8 about
    x = 2, 0.03 beyond x = 5), and `runtime_con_mu` of a randomised friction
    table (as the env draws per env) equals the reference's."""
    jm, dm, _ = scenes['slippery']
    qpos, qvel = start(dm, 4, seed=5)
    fwd = engine.forward(dm, torch.as_tensor(qpos), torch.as_tensor(qvel),
                         torch.zeros(4, jm.nu, dtype=torch.float64))
    lay = constraint_layout(dm.m)
    act = ((fwd.contacts.dist < torch.as_tensor(lay.con_incl)) & world_box_slots(dm)).numpy()
    mu = runtime_con_mu(dm, dm.geom_friction.expand(4, -1, -1))[..., 0].numpy()
    for b in range(4):
        slots = np.flatnonzero(act[b])
        assert len(slots) > 0, f'env {b} touches no slippery surface'
        want = 0.8 if qpos[b, 0] < 5.0 else 0.03
        np.testing.assert_array_equal(mu[b, slots], want)
        np.testing.assert_array_equal(lay.con_mu[slots, 0], want)
    table = np.asarray(jm.geom_friction) * np.random.RandomState(6).uniform(0.5, 1.5, (jm.ngeom, 1))
    got = runtime_con_mu(dm, torch.as_tensor(table)[None])[0].numpy()
    np.testing.assert_allclose(got, np.asarray(jcon.runtime_con_mu(jm, jnp.asarray(table))),
                               rtol=0, atol=1e-12)
