"""go2/perlin (BASELINE cfg2) end to end, and the heightfield groups of
aliengo/perlin, b2/perlin and hyqreal2/perlin, against the JAX package in
f64. Marked `slow`: the reference's whole-step program for go2/perlin
(its 20 heightfield-box pairs' per-prism CCD in it) and the box groups'
programs take minutes of XLA compile on one core, so the tier-1 run
(`-m 'not slow'`) leaves this file out. Run it alone:

    python -m pytest tests/test_torch_step_go2_perlin.py -q -m slow

* go2/perlin one step and 200 steps at B=4, as
  `test_torch_step_perlin.py` holds spot/perlin (1e-9; 1e-3 in qpos),
  the trajectory across the rounding ties of the box group's witness
  (its test's docstring).
* aliengo/perlin's sphere, capsule and box groups, b2/perlin's box group
  and hyqreal2/perlin's box group (a 6 x 6-cell footprint: 72 prisms per
  pair) through `collide` on seeded tumbled states, against the
  reference's per-env `collide` and `collide_bt`, under the bars of
  `test_torch_collision_hfield_box.py`.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import collision as jcol
from gym_quadruped_tpu.physics import collision_bt as jbt
from test_torch_collision_go2 import _check, _group_slots, _port_feat, _port_model, _poses, \
    _states
from test_torch_collision_hfield_box import check_convex, subset
from test_torch_step_perlin import one_step, perlin_scene, trajectory

pytestmark = pytest.mark.slow

GROUPS = [('aliengo', 'hfield-sphere'), ('aliengo', 'hfield-capsule'), ('aliengo', 'hfield-box'),
          ('b2', 'hfield-box'), ('hyqreal2', 'hfield-box')]
SPANS = {'aliengo': 4, 'b2': 4, 'hyqreal2': 6}


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def go2():
    return perlin_scene('go2')


def test_go2_one_step_matches_per_env_step(go2):
    one_step(go2)


def test_go2_trajectory_200_steps(go2):
    """200 steps within 1e-3 of `engine.step`, across the support ties of
    the box group's witness: at a step where the port parts from the
    reference at once, the box group on the reference's states before it
    must agree under the bars of `test_torch_collision_hfield_box.py` with
    at least one support tie whose pos differs; the port then takes the
    reference's state and goes on. Free-running, the first tie (step 132,
    env 1: one active contact's pos 1.2 mm apart) grew to 0.13 in qpos by
    step 200 as the robot tumbled; the reference's own per-env and batched
    paths part on these steps too (step 125, env 3: 1.6e-05 at step 200)."""
    jm, dm, _, _ = go2
    sub, geoms = subset(jm, 'hfield-box')
    ref_box = jax.jit(jax.vmap(lambda xp, xm: jcol.collide(sub, jbt._KinView(xp, xm)).feat))

    def tie(qpos):
        xpos, xmat = _poses(jm, qpos)
        got = _port_feat(dm, xpos, xmat)[:, :, _group_slots(dm.m)['hfield-box']]
        counts = check_convex(got, np.asarray(ref_box(xpos, xmat)), xmat[:, geoms],
                              'go2/perlin hfield-box at the parting step', [0, 1, 2])
        return counts['support ties'] > 0

    assert len(trajectory(go2, tie=tie)) <= 3


@pytest.fixture(scope='module')
def scenes():
    """robot -> (jm, dm, xpos, xmat, the port's feat) of 12 seeded tumbled
    states, the base raised by the terrain's height under the keyframe."""
    made = {}

    def get(robot):
        if robot not in made:
            jm = jload(robot, 'perlin')
            qpos = _states(jm, 12, zlib.crc32(f'{robot}/perlin'.encode()), 0.7)
            qpos[:, 2] += float(jcol.hfield_height(jm, 0.0, 0.0, jnp.float64)) \
                - float(jm.key_qpos[0, 2]) + 0.05
            xpos, xmat = _poses(jm, qpos)
            dm = _port_model(jm)
            made[robot] = jm, dm, xpos, xmat, _port_feat(dm, xpos, xmat)
        return made[robot]
    return get


@pytest.mark.parametrize('robot,group', GROUPS, ids=[f'{r}-{g}' for r, g in GROUPS])
def test_group_matches_reference(scenes, robot, group):
    jm, dm, xpos, xmat, got = scenes(robot)
    sub, geoms = subset(jm, group)
    got = got[:, :, _group_slots(dm.m)[group]]
    refs = {'per-env': np.asarray(jax.jit(jax.vmap(lambda xp, xm: jcol.collide(
                sub, jbt._KinView(xp, xm)).feat))(xpos, xmat)),
            'bt': np.asarray(jax.jit(lambda xp, xm: jbt.collide_bt(sub, xp, xm))(
                xpos, xmat)).transpose(2, 0, 1)}
    for path, ref in refs.items():
        where = f'{robot}/perlin {group} ({path})'
        if group == 'hfield-box':
            assert jcol.hfield_span(jm, geoms) == SPANS[robot]
            counts = check_convex(got, ref, xmat[:, geoms], where, [0, 1, 2])
            near = counts['near']
            assert counts['support ties'] <= max(2, 0.02 * near), counts
        else:
            near = _check(got, ref, where)
        assert near > 0, f'{where}: no slot in contact to compare pos and normal on'
