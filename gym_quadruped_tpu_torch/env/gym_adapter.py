"""Gymnasium-compatible single-env adapter over the batched QuadrupedEnv.

Counterpart of gym_quadruped_tpu/env/gym_adapter.py, the reference's
`QuadrupedEnv(gym.Env)` surface (quadruped_env.py:71): the same constructor
arguments, `reset(qpos=..., qvel=..., seed=...)` and `step(action)`
returning `(obs, reward, terminated, truncated, info)` in numpy without the
env axis, the same action and observation spaces (where gymnasium is
installed), and the kinematic and dynamic accessors (`feet_pos`,
`feet_jacobians`, `legs_mass_matrix`, ...) as `LegsAttr` of numpy arrays.

It steps the port's batched `QuadrupedEnv` at B=1 on the model's device
(the card unless the caller passes a CPU `model=`): each `step` launches
the SPD kernel twice and the Newton kernel once, and the accessors read a
Forward refreshed lazily by `engine.forward` (one launch of each). The
numpy returns of a step cost one host synchronisation. Randomness comes
from a `torch.Generator` that the adapter owns on the model's device,
seeded by `reset(seed=...)` (from numpy's global stream when the
constructor runs).

For batched simulation use `QuadrupedEnv` itself. The live viewer
(`render`) mirrors env 0 into a CPU MuJoCo passive viewer of the display
model (`models.builder.build_display_mj_model`); it needs `mujoco`, the
robot's MJCF and a display.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

try:
    import gymnasium as gym
    from gymnasium import spaces
    _GYM_BASE = gym.Env
except ImportError:  # gymnasium is an optional extra
    gym = None
    spaces = None
    _GYM_BASE = object

from gym_quadruped_tpu_torch.env import observables as obslib
from gym_quadruped_tpu_torch.env.env import QuadrupedEnv
from gym_quadruped_tpu_torch.physics import engine, forces
from gym_quadruped_tpu_torch.physics.constraints import _point_jacobians
from gym_quadruped_tpu_torch.physics.kinematics import point_jacobian_dot
from gym_quadruped_tpu_torch.utils.legs import LegsAttr
from gym_quadruped_tpu_torch.utils.maths import quat_to_euler_xyz, quat_to_mat


class QuadrupedGymEnv(_GYM_BASE):
    """Stateful gym.Env facade over one env of the batched QuadrupedEnv."""

    metadata = {'render.modes': ['human'], 'version': 0}
    ALL_OBS = QuadrupedEnv.ALL_OBS

    def __init__(self, **kwargs):
        self.core = QuadrupedEnv(**kwargs)
        self._generator = torch.Generator(device=self.core.model.device)
        self._generator.manual_seed(int(np.random.randint(0, 2**31 - 1)))
        self._state = None
        self._fwd = None        # Forward at the state, refreshed when an accessor needs it
        self.is_paused = False  # toggled by space in the viewer (teleop)

        if spaces is not None:
            low, high = self.core.action_space_bounds()
            self.action_space = spaces.Box(
                low=low.astype(np.float32), high=high.astype(np.float32),
                shape=(self.core.model.m.nu,), dtype=np.float32)
            # per-observable bounds: joint ranges, ctrlrange, [0, 1] contact flags
            # (reference configure_observation_space, quadruped_utils.py:235-325)
            self.observation_space = spaces.Dict({
                name: spaces.Box(low=lo.astype(np.float32), high=hi.astype(np.float32),
                                 shape=lo.shape, dtype=np.float32)
                for name, (lo, hi) in self.core.observation_space_limits().items()})

    # ---------------------------------------------------------------- gym API

    def _host(self, tensors) -> list:
        """numpy copies of the first env of each tensor, with one host
        synchronisation on the card (the copies are queued, then waited
        for together)."""
        dev = self.core.model.device
        if dev.type != 'cuda':
            return [t[0].numpy().copy() for t in tensors]
        out = [t[0].to('cpu', non_blocking=True) for t in tensors]
        torch.cuda.current_stream(dev).synchronize()
        return [t.numpy() for t in out]

    def reset(self, qpos=None, qvel=None, seed=None, random=True, options: dict | None = None):
        """The observations (numpy, no env axis) after a reset: random (a
        pose lifted out of contact) unless qpos, qvel or `random=False` is
        given, then at qpos (keyframe 0 by default) and qvel (0 by
        default). `options` is accepted for gym's signature and not read,
        as in the reference."""
        if seed is not None:
            self._generator.manual_seed(int(seed))
        if qpos is None and qvel is None and random:
            self._state, obs = self.core.reset(self._generator, 1)
        else:
            m = self.core.model.m
            qp = np.asarray(qpos if qpos is not None else
                            (m.key_qpos[0] if m.key_qpos.shape[0] else m.qpos0))
            qv = np.asarray(qvel if qvel is not None else np.zeros(m.nv))
            self._state, obs = self.core.reset(self._generator, 1, qpos=qp[None], qvel=qv[None])
        self._refresh_fwd()
        return dict(zip(obs, self._host(list(obs.values()))))

    def step(self, action):
        """(obs, reward, terminated, truncated, info) of one step of the env
        with the torques `action` (nu,), in numpy and Python scalars."""
        dm = self.core.model
        a = torch.as_tensor(np.asarray(action), dtype=dm.dtype)[None]
        if dm.device.type == 'cuda':   # a queued copy: no wait for the card
            a = a.pin_memory().to(dm.device, non_blocking=True)
        self._state, obs, reward, terminated, truncated, info = self.core.step(
            self._state, a, self._generator)
        self._fwd = None  # recomputed when an accessor needs it
        host = self._host([*obs.values(), reward, terminated, truncated, *info.values()])
        n = len(obs)
        return (dict(zip(obs, host[:n])), float(host[n]), bool(host[n + 1]),
                bool(host[n + 2]), dict(zip(info, host[n + 3:])))

    def _key_callback(self, keycode):
        """Viewer teleop (reference _key_callback, quadruped_env.py:1330):
        the arrows steer the velocity command, ctrl zeros it, space pauses
        (the host loop polls `self.is_paused` between steps)."""
        s = self._state
        hh = float(self.core.model.m.hip_height)
        lin = s.ref_base_lin_vel_H[0].cpu().numpy().copy()
        yaw = float(s.ref_base_ang_yaw_dot[0])
        if keycode == 262:            # arrow right
            yaw -= np.pi / 6
        elif keycode == 263:          # arrow left
            yaw += np.pi / 6
        elif keycode == 265:          # arrow up
            lin[0] += 0.25 * hh
        elif keycode == 264:          # arrow down
            lin[0] -= 0.25 * hh
        elif keycode == 345:          # ctrl
            lin[:] = 0.0
            yaw = 0.0
        elif keycode == 32:           # space
            self.is_paused = not self.is_paused
            print('Pausing simulation.' if self.is_paused else 'Resuming simulation.')
        yaw = float(np.clip(yaw, -2 * np.pi, 2 * np.pi))
        lin[0] = float(np.clip(lin[0], -6 * hh, 6 * hh))
        as_dev = lambda a: torch.as_tensor(a, dtype=s.qpos.dtype, device=s.qpos.device)
        self._state = dataclasses.replace(s, ref_base_lin_vel_H=as_dev(lin[None]),
                                          ref_base_ang_yaw_dot=as_dev([yaw]))

    def render(self, mode='human', tint_robot=False, ghost_qpos=None, ghost_alpha=0.5):
        """Live interactive viewer (reference render(), quadruped_env.py:408):
        mirrors env 0 of the state into a CPU MuJoCo passive viewer of the
        display model (one host copy), draws the actual and commanded
        velocity arrows and optional ghost robots, one per row of
        `ghost_qpos`. The physics stays on the model's device: the viewer's
        MjData is display-only."""
        import mujoco
        import mujoco.viewer as mj_viewer

        from gym_quadruped_tpu_torch.models.builder import build_display_mj_model
        from gym_quadruped_tpu_torch.utils.mujoco_visual import (
            change_robot_appearance,
            render_ghost_robot,
            render_vector,
        )

        if not hasattr(self, '_vis'):
            mj, _ = build_display_mj_model(self.core.robot_name, self.core.scene_name,
                                           self.core.model.timestep)
            if tint_robot:
                change_robot_appearance(mj, alpha=1.0)
            d = mujoco.MjData(mj)
            ghost_d = mujoco.MjData(mj)
            handle = mj_viewer.launch_passive(mj, d, key_callback=self._key_callback)
            self._vis = {'mj': mj, 'd': d, 'ghost_d': ghost_d, 'viewer': handle,
                         'arrow_ids': [-1, -1], 'ghost_geoms': {}}

        v = self._vis
        s = self._state
        qpos, qvel, ref_lin = (np.asarray(x, np.float64) for x in
                               self._host([s.qpos, s.qvel, s.ref_base_lin_vel_H]))
        v['d'].qpos[:] = qpos
        v['d'].qvel[:] = qvel
        mujoco.mj_forward(v['mj'], v['d'])

        base_pos = qpos[0:3]
        vel = qvel[0:3]
        speed = float(np.linalg.norm(vel) + 1e-9)
        v['arrow_ids'][0] = render_vector(
            v['viewer'], vel / speed, base_pos + [0, 0, 0.15], 0.3 * speed,
            color=[0.2, 0.7, 0.2, 1.0], geom_id=v['arrow_ids'][0])
        ref_speed = float(np.linalg.norm(ref_lin) + 1e-9)
        v['arrow_ids'][1] = render_vector(
            v['viewer'], ref_lin / ref_speed, base_pos + [0, 0, 0.2], 0.3 * ref_speed,
            color=[0.2, 0.2, 0.9, 1.0], geom_id=v['arrow_ids'][1])

        if ghost_qpos is not None:
            if isinstance(ghost_qpos, torch.Tensor):
                ghost_qpos = ghost_qpos.detach().cpu().numpy()
            for q in np.atleast_2d(np.asarray(ghost_qpos)):
                v['ghost_geoms'] = render_ghost_robot(
                    v['viewer'], v['mj'], v['ghost_d'], q, alpha=ghost_alpha,
                    ghost_geoms=v['ghost_geoms'])
        v['viewer'].sync()

    def close(self):
        """Close the viewer, if `render` opened one."""
        if hasattr(self, '_vis'):
            self._vis['viewer'].close()
            del self._vis

    # -------------------------------------------------------------- accessors
    # the reference's accessor surface (quadruped_env.py:488-1007), as numpy
    # and LegsAttr of numpy

    @property
    def fwd(self):
        if self._fwd is None:
            self._refresh_fwd()
        return self._fwd

    def _refresh_fwd(self):
        s = self._state
        self._fwd = engine.forward(self.core.model, s.qpos, s.qvel, s.ctrl)

    @staticmethod
    def _np(t) -> np.ndarray:
        """A numpy copy of the first env of t."""
        return t[0].cpu().numpy().copy()

    @property
    def mj_state(self):
        return self._state

    @property
    def qpos(self) -> np.ndarray:
        """Generalized positions (reference users read env.mjData.qpos)."""
        return self._np(self._state.qpos)

    @property
    def qvel(self) -> np.ndarray:
        """Generalized velocities (reference users read env.mjData.qvel)."""
        return self._np(self._state.qvel)

    @property
    def base_pos(self):
        return self.qpos[0:3]

    @property
    def base_ori_quat_wxyz(self):
        return self.qpos[3:7]

    @property
    def simulation_dt(self):
        return self.core.model.timestep

    @property
    def simulation_time(self):
        return float(self._state.time[0])

    def _legs(self, idx):
        return LegsAttr(*[np.asarray(idx[i]) for i in range(4)])

    @property
    def legs_qvel_idx(self):
        return self._legs(self.core.model.m.legs_qvel_idx)

    @property
    def legs_qpos_idx(self):
        return self._legs(self.core.model.m.legs_qpos_idx)

    @property
    def legs_tau_idx(self):
        return self._legs(self.core.model.m.legs_tau_idx)

    def _feet_xpos(self) -> torch.Tensor:
        """(1, 4, 3) the feet geoms' world positions at the Forward."""
        feet = self.core.model.const('feet_geom_id', lambda: self.core.model.m.feet_geom_id)
        return self.fwd.kin.geom_xpos[:, feet]

    def feet_pos(self, frame='world') -> LegsAttr:
        p = self._np(self._feet_xpos())
        if frame == 'base':
            R, t = self._base_RT()
            p = (p - t) @ R
        return LegsAttr(*list(p))

    def feet_jacobians(self, frame='world') -> LegsAttr:
        m = self.core.model.m
        jacp, _ = _point_jacobians(self.core.model, self.fwd.kin, self.fwd.cdof,
                                   self._feet_xpos(), m.feet_body_id)
        jacp = self._np(jacp)
        if frame == 'base':
            R, _ = self._base_RT()
            jacp = np.einsum('ij,fjv->fiv', R.T, jacp)
        return LegsAttr(*list(jacp))

    def feet_jacobians_dot(self, frame='world') -> LegsAttr:
        """mj_jacDot (reference quadruped_env.py:742)."""
        m = self.core.model.m
        pts = self._feet_xpos()
        jds = [self._np(point_jacobian_dot(self.core.model, self.fwd.kin, self.fwd.cdof,
                                           self._state.qvel, pts[:, i], int(m.feet_body_id[i])))
               for i in range(4)]
        if frame == 'base':
            R, _ = self._base_RT()
            jds = [R.T @ j for j in jds]
        return LegsAttr(*jds)

    def feet_vel(self, frame='world', relative=False) -> LegsAttr:
        """The reference's feet_vel (quadruped_env.py:631-679)."""
        jac = self.feet_jacobians('world')
        qvel = self.qvel
        feet_p = self.feet_pos('world')
        base_p = self.base_pos
        out = []
        for leg in ('FL', 'FR', 'RL', 'RR'):
            v = jac[leg] @ qvel
            if relative:
                v = v - qvel[0:3] - np.cross(qvel[3:6], feet_p[leg] - base_p)
            out.append(v)
        if frame == 'base':
            R, _ = self._base_RT()
            out = [R.T @ v for v in out]
        return LegsAttr(*out)

    def hip_positions(self, frame='world') -> LegsAttr:
        """The reference's hip_positions (quadruped_env.py:564): R.T @ hip_xpos."""
        xpos = self._np(self.fwd.kin.xpos)
        R = np.eye(3) if frame == 'world' else self._base_RT()[0]
        return LegsAttr(*[R.T @ xpos[b] if b >= 0 else None
                          for b in np.asarray(self.core.model.m.hip_body_id)])

    def get_base_inertia(self) -> np.ndarray:
        """The reflected base rotational inertia M[3:6, 3:6]
        (reference quadruped_env.py:543)."""
        return self._np(self.fwd.M)[3:6, 3:6]

    def base_lin_vel(self, frame='world'):
        v = self.qvel[0:3]
        return v if frame == 'world' else self._base_RT()[0].T @ v

    def base_ang_vel(self, frame='base'):
        w = self.qvel[3:6]
        return w if frame == 'base' else self._base_RT()[0] @ w

    def target_base_vel(self, frame='world'):
        """The commanded base linear and angular velocity (reference
        target_base_vel, quadruped_env.py:488)."""
        s = self._state
        lin, ang = obslib.target_base_vel(s.qpos, s.ref_base_lin_vel_H, s.ref_base_ang_yaw_dot)
        lin, ang = self._np(lin), self._np(ang)
        if frame == 'base':
            R = self._base_RT()[0]
            return R.T @ lin, R.T @ ang
        return lin, ang

    def base_lin_vel_err(self, frame='world'):
        """Commanded minus actual base linear velocity (quadruped_env.py:511)."""
        return self.target_base_vel(frame)[0] - self.base_lin_vel(frame)

    def base_ang_vel_err(self, frame='world'):
        """Commanded minus actual base angular velocity (quadruped_env.py:517)."""
        return self.target_base_vel(frame)[1] - self.base_ang_vel(frame)

    def base_lin_acc(self, frame='world'):
        """The base linear acceleration of the last solve (quadruped_env.py:533)."""
        a = self._np(self._state.qacc)[0:3]
        return a if frame == 'world' else self._base_RT()[0].T @ a

    @property
    def torque_ctrl_setpoint(self) -> np.ndarray:
        """The last commanded actuator torques (quadruped_env.py:999)."""
        return self._np(self._state.ctrl)

    @property
    def robot_model(self):
        """The model on its device (the reference exposes mjModel, :1028)."""
        return self.core.model

    @property
    def obs_group_reps(self):
        """The group representation of each observable (quadruped_env.py:1038);
        needs the optional morpho_symm extra."""
        from gym_quadruped_tpu_torch.utils.symmetry import (
            configure_observation_space_representations,
        )

        return configure_observation_space_representations(
            robot_name=self.core.robot_name, obs_names=self.core.state_obs_names)

    @property
    def base_configuration(self) -> np.ndarray:
        R, t = self._base_RT()
        X = np.eye(4)
        X[:3, :3] = R
        X[:3, 3] = t
        return X

    @property
    def heading_orientation_SO3(self) -> np.ndarray:
        return self._np(obslib.heading_R(self._state.qpos))

    @property
    def base_ori_euler_xyz(self) -> np.ndarray:
        return self._np(quat_to_euler_xyz(self._state.qpos[:, 3:7]))

    @property
    def gravity_vector(self) -> np.ndarray:
        return self._base_RT()[0].T @ np.array([0.0, 0.0, -1.0])

    @property
    def joint_space_state(self):
        return self.qpos[7:], self.qvel[6:]

    @property
    def kinetic_energy(self) -> float:
        qvel = self.qvel
        return float(0.5 * qvel @ self._np(self.fwd.M) @ qvel)

    @property
    def work(self) -> float:
        return float((self._np(self.fwd.M) @ self._np(self.fwd.qacc)) @ self.qvel)

    def feet_contact_state(self, frame='world', ground_reaction_forces=False):
        """Whether each foot touches, and with `ground_reaction_forces` each
        foot's force: (state, None[, forces]) like the reference
        (quadruped_env.py:799), whose middle element (MuJoCo's per-foot
        contact list) is always None: use `forces` or the contact
        observables."""
        dm = self.core.model
        cs = self._np(forces.feet_contact_state(dm, self.fwd))
        state = LegsAttr(*[bool(x) for x in cs])
        if not ground_reaction_forces:
            return state, None
        f = self._np(forces.feet_contact_forces(dm, self.fwd))
        if frame == 'base':
            R, _ = self._base_RT()
            f = f @ R
        return state, None, LegsAttr(*list(f))

    @property
    def legs_mass_matrix(self) -> LegsAttr:
        idx = self.core.model.m.legs_qvel_idx
        M = self._np(self.fwd.M)
        return LegsAttr(*[M[np.ix_(idx[i], idx[i])] for i in range(4)])

    @property
    def legs_qfrc_bias(self) -> LegsAttr:
        b = self._np(self.fwd.qfrc_bias)
        return LegsAttr(*[b[i] for i in self.core.model.m.legs_qvel_idx])

    @property
    def legs_qfrc_passive(self) -> LegsAttr:
        b = self._np(self.fwd.qfrc_passive)
        return LegsAttr(*[b[i] for i in self.core.model.m.legs_qvel_idx])

    @property
    def com(self) -> np.ndarray:
        xipos = self._np(self.fwd.kin.xipos)
        mass = np.asarray(self.core.model.m.body_mass)
        return (mass[:, None] * xipos).sum(0) / mass.sum()

    def get_hyperparameters(self):
        return self.core.get_hyperparameters()

    def _base_RT(self):
        return self._np(quat_to_mat(self._state.qpos[:, 3:7])), self.base_pos
