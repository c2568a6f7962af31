"""The port's env on the robots of the per-slot contact rows and the mesh
colliders: `QuadrupedEnv('go1' | 'mini_cheetah' | 'hyqreal1', scene)` on
the CPU in f64 resets 2 envs (the lift out of contact), takes 3 steps with
seeded torques and gives all 31 observables, each finite and of the shape
`observation_space_dims` gives; the feet's contact forces come through
`forces.simple_row_table` on go1's and mini_cheetah's unculled rows (a foot
on the floor pushes up, one off it feels nothing). Against the reference the
rows, groups and steps are held in test_torch_constraints_condim.py,
test_torch_collision_mesh.py and test_torch_step_{mesh,go1,hyqreal1}.py.
"""

import numpy as np
import pytest
import torch

from gym_quadruped_tpu_torch.env import ALL_OBS, QuadrupedEnv
from gym_quadruped_tpu_torch.models.model import load_model


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('robot,scene', [('go1', 'flat'), ('mini_cheetah', 'flat'),
                                         ('hyqreal1', 'flat'), ('mini_cheetah', 'perlin')])
def test_env_resets_steps_and_observes(robot, scene):
    dm = load_model(robot, scene, device='cpu', dtype=torch.float64)
    env = QuadrupedEnv(robot, scene=scene, model=dm, state_obs_names=ALL_OBS)
    gen = torch.Generator().manual_seed(3)
    state, obs = env.reset(gen, 2)
    actions = torch.as_tensor(np.random.RandomState(3).uniform(-2, 2, (3, 2, dm.m.nu)))
    for a in actions:
        state, obs, reward, term, trunc, info = env.step(state, a)
    dims = env.observation_space_dims()
    assert set(obs) == set(ALL_OBS)
    for name, x in obs.items():
        assert x.shape[0] == 2 and bool(torch.isfinite(x).all()), name
        assert int(np.prod(x.shape[1:])) == int(np.prod(dims[name])), name
    assert bool(torch.isfinite(state.qpos).all()) and bool(torch.isfinite(reward).all())
    touch = obs['contact_state'] > 0.5
    fz = obs['contact_forces'].reshape(2, 4, 3)[..., 2]
    assert bool((fz[touch] >= 0).all()) and bool((fz[~touch] == 0).all())
