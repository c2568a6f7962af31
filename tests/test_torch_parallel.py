"""The port's parallel/ on torch.distributed, on the CPU (gloo).

* In a single process every helper is a no-op: `initialize` without a
  coordinator, a (1, 1) mesh, the whole batch as the rank's slice,
  `all_hosts_sum` the identity, `shard_env` the env itself.
* Two ranks over gloo, each a subprocess with its own time limit, on a free
  localhost port (a hung rank fails the test instead of stalling the
  suite), on spot/flat in f64: `all_hosts_sum` of the ranks' values; a
  `shard_env` rollout of 4 envs (2 per rank, each given its own rows)
  from one explicit state against the unsharded rollout of all 4 in each
  process, to 1e-12; and
  `MPPI.solve_sharded` at K=8, H=3 against one process's `_update` over
  the two ranks' noise concatenated (each rank draws its own from
  `rank_seed(seed, rank)`), to 1e-12.

Nothing here imports JAX: the physics under the rollouts is held against
the reference by the step and MPPI tests.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gym_quadruped_tpu_torch.env import QuadrupedEnv
from gym_quadruped_tpu_torch.models.model import load_model
from gym_quadruped_tpu_torch.parallel import distributed as dist
from gym_quadruped_tpu_torch.parallel import make_mesh, rollout, shard_env

WORLD = 2
B = 4
STEPS = 3
K, H = 8, 3
SEED = 5
TIMEOUT_S = 120


def _env():
    dm = load_model('spot', 'flat', device='cpu', dtype=torch.float64)
    return QuadrupedEnv('spot', model=dm, ref_base_lin_vel=0.3, ground_friction_coeff=0.9)


def _plan(m):
    """(qpos (B, nq), qvel (B, nv), actions (B, STEPS, nu)): seeded."""
    rng = np.random.RandomState(SEED)
    qpos = np.tile(m.key_qpos[0], (B, 1))
    qpos[:, 7:] += rng.uniform(-0.05, 0.05, (B, m.nq - 7))
    return qpos, 0.1 * rng.randn(B, m.nv), rng.uniform(-2, 2, (B, STEPS, m.nu))


def _mppi(dm):
    from gym_quadruped_tpu_torch.mpc import MPPI, MPPIConfig, velocity_tracking_cost
    height = float(dm.m.key_qpos[0][2])
    return MPPI(dm, velocity_tracking_cost(dm, (0.3, 0.0, 0.0), 0.0, height),
                MPPIConfig(horizon=H, n_samples=K, sigma=1.0, solver_iterations=30))


def test_single_process_noops():
    dist.initialize()                 # nothing configured: a single process
    assert not torch.distributed.is_initialized()
    assert dist.world_size() == 1 and dist.rank() == 0
    mesh = dist.global_mesh()
    assert mesh.axis_names == ('dcn', 'ici') and mesh.shape == {'dcn': 1, 'ici': 1}
    assert mesh.size == 1 and mesh.rank == 0 and mesh.device == torch.device('cpu')
    assert dist.batch_sharding(mesh, 16) == slice(0, 16)
    x = np.arange(6.0).reshape(3, 2)
    local = dist.host_local_batch(mesh, {'x': x, 'pair': (x, torch.ones(2))})
    assert torch.equal(local['x'], torch.as_tensor(x)) and isinstance(local['pair'], tuple)
    assert dist.all_hosts_sum(2.5) == 2.5
    assert make_mesh().ranks.tolist() == [[0]]


def test_single_process_shard_env_is_the_env():
    env = _env()
    qpos, qvel, actions = _plan(env.model.m)
    reset, step = shard_env(env, make_mesh())
    gen = lambda: torch.Generator().manual_seed(0)
    s1, _ = reset(gen(), B, qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel))
    s2, _ = env.reset(gen(), B, qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel))
    run = rollout(env, STEPS, step)
    a = torch.as_tensor(actions)
    f1, obs1, r1, t1 = run(s1, a)
    f2, obs2, r2, t2 = rollout(env, STEPS)(s2, a)
    assert torch.equal(f1.qpos, f2.qpos) and torch.equal(r1, r2) and torch.equal(t1, t2)
    assert obs1['qpos'].shape == (STEPS, B, env.model.m.nq)
    with pytest.raises(ValueError, match='lies on'):
        shard_env(env, make_mesh(device='meta'))


def _worker(rank, port, out):
    """One rank of the 2-rank run: writes its readings to `out` as JSON."""
    dist.initialize(f'localhost:{port}', WORLD, rank)
    mesh = dist.global_mesh()
    result = {'rank': mesh.rank, 'shape': mesh.shape, 'slice': [
        dist.batch_sharding(mesh, B).start, dist.batch_sharding(mesh, B).stop]}
    result['sum'] = dist.all_hosts_sum(1.5 + rank)

    env = _env()
    qpos, qvel, actions = _plan(env.model.m)
    a = torch.as_tensor(actions)
    rows = dist.batch_sharding(mesh, B)
    reset, step = shard_env(env, mesh)
    state, _ = reset(torch.Generator().manual_seed(rank), B, qpos=torch.as_tensor(qpos[rows]),
                     qvel=torch.as_tensor(qvel[rows]))
    final, obs, rew, term = rollout(env, STEPS, step)(state, a[rows])
    with pytest.raises(ValueError, match='rows'):      # the whole batch is not the rank's
        step(state, a[:, 0])
    full, _ = env.reset(torch.Generator().manual_seed(0), B, qpos=torch.as_tensor(qpos),
                        qvel=torch.as_tensor(qvel))
    full_final, full_obs, _, _ = rollout(env, STEPS)(full, a)
    result['local_rows'] = final.qpos.shape[0]
    result['rollout_err'] = max((final.qpos - full_final.qpos[rows]).abs().max().item(),
                                (obs['qvel'] - full_obs['qvel'][:, rows]).abs().max().item())

    mppi = _mppi(env.model)
    qp = torch.as_tensor(env.model.m.key_qpos[0])
    qv = torch.zeros(env.model.m.nv, dtype=torch.float64)
    u0 = torch.as_tensor(np.random.RandomState(1).uniform(-1, 1, (H, env.model.m.nu)))
    u, info = mppi.solve_sharded(mesh, SEED, qp, qv, u0)
    # one process's update over both ranks' noise
    from gym_quadruped_tpu_torch.mpc.mppi import rank_seed
    eps = torch.cat([mppi.cfg.sigma * torch.randn(
        (K // WORLD, H, env.model.m.nu), generator=torch.Generator().manual_seed(rank_seed(SEED, r)),
        dtype=torch.float64) for r in range(WORLD)])
    want, want_info = mppi._update(u0, eps, mppi._rollout_cost(qp, qv, u0[None] + eps))
    result['mppi_err'] = (u - want).abs().max().item()
    result['mppi_du'] = (want - u0).abs().max().item()
    result['best_err'] = abs(float(info['best_cost']) - float(want_info['best_cost']))
    result['ess_err'] = abs(float(info['ess']) - float(want_info['ess']))
    result['ess'] = float(info['ess'])
    Path(out).write_text(json.dumps(result))
    torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('ranks')
    port = _free_port()
    root = str(Path(__file__).resolve().parents[1])
    env = {**os.environ, 'OMP_NUM_THREADS': '1',
           'PYTHONPATH': os.pathsep.join([root] + [p for p in [os.environ.get('PYTHONPATH')] if p])}
    for k in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK'):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port), str(tmp / f'{r}.json')],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f'rank {r} failed:\n{log[-3000:]}'
    return [json.loads((tmp / f'{r}.json').read_text()) for r in range(WORLD)]


def test_mesh_and_sum(two_ranks):
    for r, res in enumerate(two_ranks):
        assert res['rank'] == r and res['shape'] == {'dcn': 1, 'ici': 2}
        assert res['slice'] == [2 * r, 2 * r + 2]
        assert res['sum'] == 1.5 + 2.5


def test_shard_env_rollout(two_ranks):
    for res in two_ranks:
        assert res['local_rows'] == B // WORLD
        assert res['rollout_err'] < 1e-12, res


def test_solve_sharded(two_ranks):
    for res in two_ranks:
        assert res['mppi_du'] > 1e-3, 'the update moved nothing: a trivial comparison'
        assert res['mppi_err'] < 1e-12 and res['best_err'] < 1e-12 and res['ess_err'] < 1e-9, res
        assert 1.0 <= res['ess'] <= K
    assert two_ranks[0]['mppi_err'] == two_ranks[1]['mppi_err']


if __name__ == '__main__':
    torch.set_num_threads(1)
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
