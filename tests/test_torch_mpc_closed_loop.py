"""The slice as a whole: go2/flat trotting under the port's MPC, in f64.

The port's closed loop on the CPU: `QuadrupedEnv('go2', scene='flat')`, two
envs reset from the keyframe (one with its joints moved by a few
centiradians), 40 env steps with a replan every 5 (cold 50-iteration ADMM
at step 0, warm 10-iteration replans after), the tick of the port's
examples/go2_mpc_locomotion.py itself: fk, cdof, the feet's world Jacobians,
`solve`, `torques`, with per-env forward commands of 0.4 and 0.3 m/s.

* At every replan the reference's tick (`jax.vmap` of the same functions of
  the JAX package, jitted once per form) on the same state and warm start
  gives the same torques and warm start, to 1e-8 of 1 + max|reference|.
* The torque sequence stays within 0.5 N m of the one the scipy SLSQP
  solution of the same QP gives (the rule of tests/test_mpc_closed_loop.py,
  whose f64 numpy condensing and SLSQP this file reuses), on the port's
  own states. SLSQP gets the QP that ADMM solves, min 1/2 U^T Hq U + q^T U
  over the pyramids. The reference's test hands it Hq + rho I, whose rho =
  1e-4 outweighs the force effort r_diag = 1e-5 tenfold: that is another
  QP, and the reference's test fails its own 0.5 bar on the reference's
  own closed loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.mpc import CentroidalMPC as JMPC
from gym_quadruped_tpu.mpc import GaitConfig as JGait
from gym_quadruped_tpu.mpc import MPCConfig as JConfig
from gym_quadruped_tpu.physics.constraints import _point_jacobians as jjac
from gym_quadruped_tpu.physics.kinematics import cdof as jcdof
from gym_quadruped_tpu.physics.kinematics import fk as jfk
from gym_quadruped_tpu_torch.env import QuadrupedEnv
from gym_quadruped_tpu_torch.examples.go2_mpc_locomotion import feet_and_jacobians, tick
from gym_quadruped_tpu_torch.models.model import load_model
from gym_quadruped_tpu_torch.mpc import CentroidalMPC, GaitConfig, MPCConfig
from gym_quadruped_tpu_torch.mpc import centroidal as srb
from gym_quadruped_tpu_torch.mpc.gait import contact_schedule
from gym_quadruped_tpu_torch.utils.maths import quat_to_euler_xyz
from test_mpc_closed_loop import _np_condense, _scipy_qp
from test_torch_step import _close

N_STEPS = 40
REPLAN = 5
VX = (0.4, 0.3)


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_tick(dm, mpc, state, ref, warm):
    """The drive's tick; with it the forces of its plan (the ADMM's z, the
    warm start's second part) and the feet and Jacobians it solved at."""
    tau, warm = tick(mpc, state, ref, warm)
    feet, jacp = feet_and_jacobians(dm, state)
    return tau, warm, warm[1].reshape(len(tau), mpc.cfg.horizon, 4, 3), feet, jacp


def _ref_ticks(jm, cfg):
    """The reference's tick, vmapped over envs: cold and warm forms."""
    mpc = JMPC(jm, cfg)

    def tick(qpos, qvel, time, ref, warm):
        kin = jfk(jm, qpos)
        feet = kin.geom_xpos[jnp.asarray(jm.feet_geom_id)]
        jacp, _ = jjac(jm, kin, jcdof(jm, kin), feet, jm.feet_body_id)
        forces, warm = mpc.solve(qpos, qvel, feet, time, ref, jnp.asarray(0.0), warmstart=warm)
        return mpc.torques(qpos, qvel, feet, jacp, forces[0], time, ref), warm

    cold = jax.jit(jax.vmap(lambda q, v, t, r: tick(q, v, t, r, None)))
    warm = jax.jit(jax.vmap(tick))
    return cold, warm


def test_closed_loop_matches_reference_and_scipy():
    dm = load_model('go2', 'flat', device='cpu', dtype=torch.float64)
    m = dm.m
    env = QuadrupedEnv('go2', state_obs_names=('qpos', 'qvel'), scene='flat', model=dm)
    cfg = MPCConfig(gait=GaitConfig('trot', period=0.5), iterations=50)
    mpc = CentroidalMPC(dm, cfg)
    ref_cold, ref_warm = _ref_ticks(jload('go2', 'flat'),
                                    JConfig(gait=JGait('trot', period=0.5), iterations=50))
    B = len(VX)
    qpos0 = np.tile(m.key_qpos[0], (B, 1))
    qpos0[1, 7:] += np.random.RandomState(0).uniform(-0.05, 0.05, m.nq - 7)
    ref = torch.tensor([[vx, 0.0, 0.0] for vx in VX], dtype=torch.float64)
    state, _ = env.reset(torch.Generator().manual_seed(0), B, qpos=torch.as_tensor(qpos0),
                         qvel=torch.zeros(B, m.nv, dtype=torch.float64))

    warm = None
    tau_err, f_scale = [], []
    for i in range(N_STEPS):
        if i % REPLAN == 0:
            args = [jnp.asarray(x.numpy()) for x in (state.qpos, state.qvel, state.time, ref)]
            if warm is None:
                jtau, jwarm = ref_cold(*args)
            else:
                jtau, jwarm = ref_warm(*args, tuple(jnp.asarray(w.numpy()) for w in warm))
            tau, warm, forces, feet, jacp = _port_tick(dm, mpc, state, ref, warm)
            _close(tau, np.asarray(jtau), 1e-8, f'torques at step {i}')
            for got, want, name in zip(warm, jwarm, ('U', 'z', 'y')):
                _close(got, np.asarray(want), 1e-8, f'warm start {name} at step {i}')

            # the same QP, condensed in numpy f64 and solved by SLSQP
            euler = quat_to_euler_xyz(state.qpos[:, 3:7])
            x0 = srb.state_from_env(state.qpos, state.qvel, euler)
            sched = contact_schedule(cfg.gait, state.time, cfg.horizon, cfg.mpc_dt)
            A, Bm = srb.build_horizon(mpc.params, euler[:, 2], feet - state.qpos[:, None, 0:3],
                                      sched, cfg.mpc_dt)
            x_ref = srb.reference_trajectory(x0, ref, torch.zeros(B, dtype=torch.float64),
                                             mpc.stand_height, cfg.horizon, cfg.mpc_dt)
            f_ref = []
            for b in range(B):
                Hq, qv = _np_condense(A[b].numpy(), Bm[b].numpy(), x0[b].numpy(),
                                      x_ref[b].numpy(), np.asarray(cfg.weights.q_diag),
                                      cfg.weights.r_diag)
                U_ref = _scipy_qp(Hq, qv, sched[b].reshape(-1).numpy(),
                                  mpc.params.mu, mpc.params.fz_min, mpc.params.fz_max,
                                  forces[b].reshape(-1).numpy())
                f_ref.append(U_ref.reshape(cfg.horizon, 4, 3)[0])
            tau_ref = mpc.torques(state.qpos, state.qvel, feet, jacp,
                                  torch.as_tensor(np.stack(f_ref)), state.time, ref)
            tau_err.append(float((tau - tau_ref).abs().max()))
            f_scale.append(float(forces.abs().max()))
        state, *_ = env.step(state, tau)

    assert torch.isfinite(state.qpos).all()
    worst = max(tau_err)
    # the reference's rule: cold ADMM-50 sits within 0.05 N of the SLSQP
    # optimum and a warm 10-iteration replan adds at most 0.3 N m of
    # first-knot torque; 0.5 N m on a ~30 N m torque scale bounds both
    assert worst < 0.5, (f'closed-loop torques part from the SLSQP QP by {worst:.3f} N m over '
                         f'{len(tau_err)} replans (force scale {max(f_scale):.1f} N)')
