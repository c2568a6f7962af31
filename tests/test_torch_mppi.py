"""The port's MPPI against the JAX package's, on spot/flat in f64.

spot/flat's physics program is the cheapest of the reference's to compile.
K=8 rollouts of H=3 steps from the keyframe at a Newton cap of 30, so that
both packages' solves converge (two programs stopped at a looser cap part
at ~1e-8-1e-5: test_torch_env_physics.py).

* The rollout costs of given control sequences against
  `jax.vmap(MPPI._rollout_cost)`: 1e-8 relative.
* `_update` on the same noise and costs: the plan to 1e-12, best cost and
  effective sample size to 1e-12.
* `shift` is exact; `solve_sharded` in a single process (no process
  group, a mesh of one rank) is `solve` with a generator of the same seed,
  bit for bit (tests/test_torch_parallel.py holds it over 2 ranks).
* A solve from a generator improves on the nominal plan (within 5%), as
  tests/test_mppi.py holds the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.mpc import MPPI as JMPPI
from gym_quadruped_tpu.mpc import MPPIConfig as JConfig
from gym_quadruped_tpu.mpc import velocity_tracking_cost as jcost
from gym_quadruped_tpu_torch.models.model import load_model
from gym_quadruped_tpu_torch.mpc import MPPI, MPPIConfig, velocity_tracking_cost
from gym_quadruped_tpu_torch.parallel import make_mesh

K, H = 8, 3
CONFIG = dict(horizon=H, n_samples=K, sigma=1.0, solver_iterations=30)
REF = (0.3, 0.0, 0.0)


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def spot():
    dm = load_model('spot', 'flat', device='cpu', dtype=torch.float64)
    jm = jload('spot', 'flat')
    height = float(jm.key_qpos[0][2])
    port = MPPI(dm, velocity_tracking_cost(dm, REF, 0.0, height), MPPIConfig(**CONFIG))
    ref = JMPPI(jm, jcost(jm, jnp.asarray(REF), jnp.asarray(0.0), height), JConfig(**CONFIG))
    qpos = np.asarray(jm.key_qpos[0], np.float64)
    qvel = np.zeros(jm.nv)
    return port, ref, qpos, qvel


def test_rollout_costs_match(spot):
    port, ref, qpos, qvel = spot
    ctrls = np.random.RandomState(0).uniform(-2, 2, (K, H, port.model.m.nu))
    got = port._rollout_cost(torch.as_tensor(qpos), torch.as_tensor(qvel), torch.as_tensor(ctrls))
    want = jax.jit(jax.vmap(lambda c: ref._rollout_cost(jnp.asarray(qpos), jnp.asarray(qvel), c)))(
        jnp.asarray(ctrls))
    assert got.shape == (K,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=0)


def test_update_matches(spot):
    port, ref, _, _ = spot
    rng = np.random.RandomState(1)
    u0 = rng.uniform(-1, 1, (H, 12))
    eps = rng.randn(K, H, 12)
    costs = rng.uniform(5.0, 9.0, K)
    u1, info = port._update(torch.as_tensor(u0), torch.as_tensor(eps), torch.as_tensor(costs))
    ju1, jinfo = ref._update(jnp.asarray(u0), jnp.asarray(eps), jnp.asarray(costs))
    np.testing.assert_allclose(u1.numpy(), np.asarray(ju1), rtol=0, atol=1e-12)
    for key in ('best_cost', 'ess'):
        np.testing.assert_allclose(float(info[key]), float(jinfo[key]), rtol=1e-12, err_msg=key)
    assert 1.0 <= float(info['ess']) <= K


def test_shift_and_sharded(spot):
    port, ref, qpos, qvel = spot
    u = np.random.RandomState(2).randn(H, 12)
    fill = np.arange(12.0)
    for f in (None, fill):
        got = MPPI.shift(torch.as_tensor(u), None if f is None else torch.as_tensor(f))
        want = JMPPI.shift(jnp.asarray(u), None if f is None else jnp.asarray(f))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    qp, qv, u0 = torch.as_tensor(qpos), torch.as_tensor(qvel), torch.zeros(H, 12, dtype=torch.float64)
    got, got_info = port.solve_sharded(make_mesh(), 7, qp, qv, u0)
    want, want_info = port.solve(torch.Generator().manual_seed(7), qp, qv, u0)
    assert torch.equal(got, want)
    for key in ('best_cost', 'ess'):
        assert torch.equal(got_info[key], want_info[key]), key


def test_solve_improves_cost(spot):
    port, _, qpos, qvel = spot
    qp, qv = torch.as_tensor(qpos), torch.as_tensor(qvel)
    u0 = torch.zeros(H, 12, dtype=torch.float64)
    u1, info = port.solve(torch.Generator().manual_seed(0), qp, qv, u0)
    assert u1.shape == u0.shape
    c0, c1 = (float(port._rollout_cost(qp, qv, u[None])[0]) for u in (u0, u1))
    assert np.isfinite(c1)
    assert c1 <= c0 * 1.05, (c0, c1)
    assert 1.0 <= float(info['ess']) <= K
