"""QuadrupedEnv: the environment over a batch of envs.

Counterpart of gym_quadruped_tpu/env/env.py (the reference's QuadrupedEnv,
quadruped_env.py:71-1433), batched natively: `reset(generator, B)` gives
(state, obs) of B envs and `step(state, action)` gives (state', obs,
reward, terminated, truncated, info), every tensor with a leading env axis,
on the model's device and in its dtype (`models.model.load_model`, the card
by default). Per step the physics launches the SPD kernel twice and the
fused Newton kernel once on the card; the env adds no host synchronisation.

Configuration (command type, ranges, observables, disturbances, sensors)
is the reference's constructor arguments, held by the env object.
Randomness comes from a `torch.Generator` on the model's device that the
caller passes, so draws are not reproducible against the reference's JAX
streams; explicit qpos and qvel with scalar ranges make a reset
deterministic. Sensors (`sensors.IMU`, `HeightMap`, `Camera`) are built
with (model, **kwargs) and read the state before each step with the step's
Forward; their observables are routed by name. A noisy IMU needs the
generator in every `step`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
from torch.profiler import record_function

from gym_quadruped_tpu_torch.env import observables as obslib
from gym_quadruped_tpu_torch.env.state import EnvState
from gym_quadruped_tpu_torch.models.model import DeviceModel, load_model
from gym_quadruped_tpu_torch.models.robots import get_robot_config
from gym_quadruped_tpu_torch.physics import engine
from gym_quadruped_tpu_torch.physics.collision import collide
from gym_quadruped_tpu_torch.physics.constraints import constraint_layout, runtime_con_mu
from gym_quadruped_tpu_torch.physics.forces import feet_slot_mask, invalid_contact
from gym_quadruped_tpu_torch.physics.kinematics import fk
from gym_quadruped_tpu_torch.utils.maths import euler_xyz_to_quat, process_range

# the reference's cap on the rounds of the lift out of contact at reset
LIFT_ROUNDS = 100


class QuadrupedEnv:
    """Batched quadruped environment. See the module docstring."""

    ALL_OBS = obslib.ALL_OBS
    _DEFAULT_OBS = ('qpos', 'qvel', 'tau_ctrl_setpoint', 'feet_pos:base',
                    'feet_vel:base')

    def __init__(
        self,
        robot: str,
        state_obs_names: Sequence[str] = _DEFAULT_OBS,
        scene: str = 'flat',
        sim_dt: float = 0.002,
        base_vel_command_type: str = 'forward',
        ref_base_lin_vel=0.5,
        ref_base_ang_vel=0.0,
        ground_friction_coeff=1.0,
        legs_order: tuple = ('FL', 'FR', 'RL', 'RR'),
        sensors: Sequence[type] | None = None,
        sensors_kwargs: Sequence[dict] | None = None,
        external_disturbances_kwargs: dict | None = None,
        model: DeviceModel | None = None,
        solver_iterations: int | None = None,
        max_contacts: int | None = None,
    ):
        self.robot_name = robot
        self.robot_cfg = get_robot_config(robot)
        self.scene_name = scene
        self.base_vel_command_type = base_vel_command_type
        self.base_lin_vel_range = ref_base_lin_vel if callable(ref_base_lin_vel) \
            else process_range(ref_base_lin_vel)
        self.base_ang_vel_range = ref_base_ang_vel if callable(ref_base_ang_vel) \
            else process_range(ref_base_ang_vel)
        self.ground_friction_coeff_range = process_range(ground_friction_coeff)
        assert tuple(legs_order) == ('FL', 'FR', 'RL', 'RR'), \
            'leg arrays are fixed FL,FR,RL,RR order'
        self.legs_order = tuple(legs_order)
        self.state_obs_names = tuple(state_obs_names)
        self.external_disturbances_kwargs = external_disturbances_kwargs
        self.solver_iterations = (engine.DEFAULT_SOLVER_ITERS if solver_iterations is None
                                  else solver_iterations)
        # per-scene override of the cone-contact cap: raise it for cluttered
        # scenes where more than 32 slots can touch at once
        self.max_contacts = (engine.MAX_CONE_CONTACTS if max_contacts is None
                             else int(max_contacts))

        self.model = model if model is not None else load_model(robot, scene, sim_dt)
        m = self.model.m
        self.terrain_limits = m.terrain_limits
        # rounds of the lift out of contact in the last random reset (host int)
        self.lift_rounds = 0

        # sensors, built with (model, **kwargs) on the sensor protocol
        # (sensors/base.py); their states ride in EnvState.sensors
        sensors_kwargs = sensors_kwargs or [{}] * len(sensors or ())
        self.sensors = [cls(model=self.model, **kw)
                        for cls, kw in zip(sensors or (), sensors_kwargs)]

        # geoms whose friction is randomised: ground-named geoms and the feet
        # (reference _set_ground_friction, quadruped_env.py:1277-1298)
        mask = np.array([bool(n) and n.lower() in ('ground', 'floor', 'hfield', 'terrain')
                         for n in m.geom_names], bool)
        mask[np.asarray(m.feet_geom_id)] = True
        self._friction_geom_mask = mask

        # Callable velocity commands (time [s] -> velocity) are tabulated here
        # on the step's time grid, 60 s long and clamped beyond, and looked up
        # by sim time in `step`, as the reference does (env.py:115-131).
        self._vel_table_dt = float(m.timestep)
        n_tab = int(round(60.0 / self._vel_table_dt)) + 1
        as_dev = lambda a: torch.as_tensor(a, dtype=self.model.dtype, device=self.model.device)
        self._lin_vel_table = self._ang_vel_table = None
        if callable(self.base_lin_vel_range):
            fn = self.base_lin_vel_range
            self._lin_vel_table = as_dev(np.stack([np.broadcast_to(
                np.asarray(fn(k * self._vel_table_dt), np.float64), (3,))
                for k in range(n_tab)]))                                   # (T, 3)
        if callable(self.base_ang_vel_range):
            fn = self.base_ang_vel_range
            self._ang_vel_table = as_dev(np.array([
                float(np.asarray(fn(k * self._vel_table_dt)).reshape(-1)[-1])
                for k in range(n_tab)]))                                   # (T,)

        for name in self.state_obs_names:   # validate the names early
            if self._sensor_of(name) is None:
                obslib.obs_dim(m, name)

        self._hparams = dict(
            robot=robot, state_obs_names=tuple(state_obs_names), scene=scene,
            sim_dt=sim_dt, base_vel_command_type=base_vel_command_type,
            ref_base_lin_vel=ref_base_lin_vel, ref_base_ang_vel=ref_base_ang_vel,
            ground_friction_coeff=ground_friction_coeff, legs_order=tuple(legs_order),
            external_disturbances_kwargs=external_disturbances_kwargs,
            max_contacts=max_contacts)

    # ------------------------------------------------------------------ helpers

    def _sensor_of(self, name: str):
        """The first sensor that observes `name`, or None."""
        return next((s for s in self.sensors if name in s.available_observations()), None)

    def observation_space_dims(self) -> dict:
        dims = {}
        for name in self.state_obs_names:
            sensor = self._sensor_of(name)
            dims[name] = (obslib.obs_dim(self.model.m, name) if sensor is None
                          else sensor.observation_dim(name))
        return dims

    def observation_space_limits(self) -> dict:
        """name -> (low, high) bounds (reference configure_observation_space,
        quadruped_utils.py:235-325); sensor observables are unbounded."""
        lims = {}
        for name in self.state_obs_names:
            sensor = self._sensor_of(name)
            if sensor is None:
                lims[name] = obslib.obs_limits(self.model.m, name)
            else:
                d = sensor.observation_dim(name)
                lims[name] = (np.full(d, -np.inf), np.full(d, np.inf))
        return lims

    def action_space_bounds(self) -> tuple:
        """(low, high) torque bounds (reference quadruped_env.py:214-225)."""
        m = self.model.m
        low = np.where(m.actuator_forcelimited, m.actuator_forcerange[:, 0], -np.inf)
        high = np.where(m.actuator_forcelimited, m.actuator_forcerange[:, 1], np.inf)
        return low, high

    def get_hyperparameters(self) -> dict:
        """The constructor's arguments, from which an equivalent env can be
        made (reference _save_hyperparameters, quadruped_env.py:1352)."""
        return dict(self._hparams)

    @property
    def simulation_dt(self) -> float:
        return self.model.timestep

    def _uniform(self, gen, B, lo, hi, *shape):
        """(B, *shape) draws from U(lo, hi) in the model's dtype; exactly lo
        when lo == hi."""
        u = torch.rand(B, *shape, generator=gen, dtype=self.model.dtype,
                       device=self.model.device)
        return lo + (hi - lo) * u

    def _randint(self, gen, B):
        return torch.randint(1000, 3000, (B,), generator=gen, dtype=torch.int32,
                             device=self.model.device)

    def _never(self, B):
        return torch.full((B,), -1, dtype=torch.int32, device=self.model.device)

    # ------------------------------------------------------- command sampling

    def _sample_ref_vel(self, gen, B):
        """(lin_vel_H (B, 3), yaw_dot (B,), steps_until (B,)), the reference's
        _sample_ref_vel (env.py:209-244, quadruped_env.py:1046-1072)."""
        dev, dtype = self.model.device, self.model.dtype
        ct = self.base_vel_command_type
        zeros = lambda *s: torch.zeros(B, *s, dtype=dtype, device=dev)
        if self._lin_vel_table is not None or self._ang_vel_table is not None:
            # callable commands follow the time table in `step`: the t = 0
            # entry, never resampled
            lin = (self._lin_vel_table[0].expand(B, 3) if self._lin_vel_table is not None
                   else zeros(3))
            yaw = (self._ang_vel_table[0].expand(B) if self._ang_vel_table is not None
                   else zeros())
            return lin, yaw, self._never(B)
        lo, hi = self.base_lin_vel_range
        if 'forward' in ct:
            norm = self._uniform(gen, B, lo, hi)
            head = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev).expand(B, 3)
        elif 'random' in ct:
            norm = self._uniform(gen, B, lo, hi)
            ang = self._uniform(gen, B, -math.pi, math.pi)
            head = torch.stack([torch.cos(ang), torch.sin(ang), torch.zeros_like(ang)], -1)
        elif 'human' in ct:
            norm = zeros()
            head = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev).expand(B, 3)
        else:
            raise ValueError(f'Invalid base velocity command type: {ct}')
        yaw_dot = self._uniform(gen, B, *self.base_ang_vel_range) if 'rotate' in ct else zeros()
        steps = self._randint(gen, B) if 'reset' in ct else self._never(B)
        return norm[:, None] * head, yaw_dot, steps

    def _sample_disturbance(self, gen, B):
        """(wrench (B, 6), steps_until (B,)), the reference's
        _sample_disturbance (env.py:246-265, quadruped_env.py:1074-1139)."""
        kw = self.external_disturbances_kwargs
        dev, dtype = self.model.device, self.model.dtype
        if kw is None:
            return torch.zeros(B, 6, dtype=dtype, device=dev), self._never(B)
        vals = []
        for axis in ('x', 'y', 'z', 'roll', 'pitch', 'yaw'):
            spec = kw.get(axis)
            if spec is None:
                vals.append(torch.zeros(B, dtype=dtype, device=dev))
            elif len(spec) == 1:
                vals.append(torch.full((B,), float(spec[0]), dtype=dtype, device=dev))
            else:
                vals.append(self._uniform(gen, B, float(spec[0]), float(spec[1])))
        steps = self._randint(gen, B) if kw.get('type') == 'reset' else self._never(B)
        return torch.stack(vals, -1), steps

    def _sample_friction(self, gen, B):
        """(B, ngeom, 3) friction tables: the ground and feet geoms' sliding
        friction drawn per env, torsional 0.005, rolling 0
        (quadruped_env.py:1284-1286); the model's elsewhere."""
        dm = self.model
        t = self._uniform(gen, B, *self.ground_friction_coeff_range)
        new = torch.stack([t, torch.full_like(t, 0.005), torch.zeros_like(t)], -1)
        mask = dm.const('friction_geom_mask', lambda: self._friction_geom_mask)[:, None]
        return torch.where(mask, new[:, None, :], dm.geom_friction)

    # ----------------------------------------------------------------- reset

    def _randomize_qpos(self, gen, B, options=None):
        """Keyframe 0 with uniform joint noise and joint velocities, spawned at
        a uniform xy within the terrain limits at hip height, facing the
        origin, with uniform roll and pitch (quadruped_env.py:342-373)."""
        dm = self.model
        m = dm.m
        options = options or {}
        key = m.key_qpos[0] if m.key_qpos.shape[0] else m.qpos0
        qpos = torch.as_tensor(key, dtype=dm.dtype, device=dm.device).repeat(B, 1)
        qvel = torch.zeros(B, m.nv, dtype=dm.dtype, device=dm.device)
        amp = options.get('angle_sweep', 20 * math.pi / 180)
        qpos[:, 7:] += self._uniform(gen, B, -amp, amp, m.nq - 7)
        qvel[:, 6:] = self._uniform(gen, B, -0.5, 0.5, m.nv - 6)
        # terrain_limits is (x_max, x_min, y_max, y_min); the bounds are ordered
        x_max, x_min, y_max, y_min = m.terrain_limits
        x = self._uniform(gen, B, min(x_min, x_max), max(x_min, x_max))
        y = self._uniform(gen, B, min(y_min, y_max), max(y_min, y_max))
        qpos[:, 0], qpos[:, 1] = x, y
        qpos[:, 2] = m.hip_height
        roll = options.get('roll_sweep', 10 * math.pi / 180)
        pitch = options.get('pitch_sweep', 10 * math.pi / 180)
        # yaw faces the origin: atan2 of (origin - spawn), math_utils.py:37-51
        euler = torch.stack([self._uniform(gen, B, -roll, roll),
                             self._uniform(gen, B, -pitch, pitch),
                             torch.atan2(-y, -x)], -1)
        qpos[:, 3:7] = euler_xyz_to_quat(euler)
        return qpos, qvel

    def _feet_penetration(self, qpos):
        """(B,) bool: a foot slot is in contact; (B,) its deepest |dist|."""
        dm = self.model
        lay = constraint_layout(dm.m)
        foot = dm.const('foot_slot', lambda: np.any(feet_slot_mask(dm.m) > 0, axis=0))
        dist = collide(dm, fk(dm, qpos)).dist
        act = (dist < dm.const('con_incl', lambda: lay.con_incl)) & foot
        return act.any(-1), torch.where(act, dist.abs(), 0.0).amax(-1)

    def _lift_until_no_contact(self, qpos):
        """(qpos, rounds): raise each env's base until no foot touches,
        at most LIFT_ROUNDS rounds of 1.1 times the deepest foot penetration
        (quadruped_env.py:376-388). Each env stops on its own condition, as
        the reference's per-env while_loop does under vmap; a round steps
        only the envs still in contact and syncs with the host twice. Where
        the lift moves none of them (a penetration of ~1e-9 m is below the
        dtype's resolution of z), every round left would repeat this one:
        the loop ends there with the cap's count, the same result."""
        dm = self.model
        if len(constraint_layout(dm.m).con_condim) == 0:
            return qpos, 0
        qpos = qpos.clone()
        in_contact, pen = self._feet_penetration(qpos)
        envs = torch.arange(qpos.shape[0], device=qpos.device)
        rounds = 0
        while rounds < LIFT_ROUNDS:
            keep = in_contact.nonzero()[:, 0]
            if keep.numel() == 0:
                break
            envs, pen = envs[keep], pen[keep]
            z = qpos[envs, 2]
            lifted = z + 1.1 * pen
            if not bool((lifted != z).any()):
                rounds = LIFT_ROUNDS
                break
            qpos[envs, 2] = lifted
            in_contact, pen = self._feet_penetration(qpos[envs])
            rounds += 1
        return qpos, rounds

    def reset(self, generator: torch.Generator, B: int, qpos=None, qvel=None,
              options: dict | None = None) -> tuple[EnvState, dict]:
        """(state, obs) of B envs (quadruped_env.py:309-406): a random pose
        lifted out of contact, or the given qpos (B, nq) and qvel (B, nv);
        commands, friction and disturbances drawn from `generator`; then one
        zero-torque step refreshes the whole pipeline, and the sensors start
        and read once at the state before it, with its Forward."""
        dm = self.model
        m = dm.m
        if qpos is None and qvel is None:
            qp, qv = self._randomize_qpos(generator, B, options)
            qp, self.lift_rounds = self._lift_until_no_contact(qp)
        else:
            qp = torch.as_tensor(qpos, dtype=dm.dtype, device=dm.device).expand(B, m.nq)
            qv = (torch.zeros(B, m.nv, dtype=dm.dtype, device=dm.device) if qvel is None
                  else torch.as_tensor(qvel, dtype=dm.dtype, device=dm.device).expand(B, m.nv))
        ref_lin_H, yaw_dot, vel_steps = self._sample_ref_vel(generator, B)
        friction = self._sample_friction(generator, B)
        wrench, dist_steps = self._sample_disturbance(generator, B)
        ctrl = torch.zeros(B, m.nu, dtype=dm.dtype, device=dm.device)
        qp2, qv2, fwd = engine.step_batched(
            dm, qp, qv, ctrl, solver_iterations=self.solver_iterations,
            max_contacts=self.max_contacts, con_mu=runtime_con_mu(dm, friction))
        state = EnvState(
            qpos=qp2, qvel=qv2, ctrl=ctrl, qacc=fwd.qacc,
            time=torch.full((B,), m.timestep, dtype=dm.dtype, device=dm.device),
            step_num=torch.zeros(B, dtype=torch.int32, device=dm.device),
            ref_base_lin_vel_H=ref_lin_H, ref_base_ang_yaw_dot=yaw_dot,
            steps_until_resample_vel=vel_steps,
            external_wrench=wrench, steps_until_resample_wrench=dist_steps,
            geom_friction=friction,
            sensors=tuple(s.init(generator, B) for s in self.sensors))
        state = self._step_sensors(state, qp, qv, fwd, generator)
        return state, self._obs(state, fwd)

    # ------------------------------------------------------------------ step

    def step(self, state: EnvState, action, generator: torch.Generator | None = None):
        """(state', obs, reward, terminated, truncated, info) of one step of
        every env (quadruped_env.py:251-306): warm-started from state.qacc,
        with the state's friction and disturbance; the sensors read the
        state before the step with its Forward. `generator` draws the
        commands and disturbances that a 'reset' type resamples and the
        sensors' noise."""
        dm = self.model
        m = dm.m
        B = state.qpos.shape[0]
        ctrl = torch.as_tensor(action, dtype=dm.dtype, device=dm.device)
        qfrc_applied = None
        if self.external_disturbances_kwargs is not None:
            qfrc_applied = torch.cat(
                [state.external_wrench, state.qvel.new_zeros(B, m.nv - 6)], -1)
        # the previous step's qacc warm-starts the Newton solve (MuJoCo's
        # qacc_warmstart): on hard multi-contact states the cold solve needs
        # more iterations than the cap
        qp, qv, fwd = engine.step_batched(
            dm, state.qpos, state.qvel, ctrl, warmstart=state.qacc,
            solver_iterations=self.solver_iterations, max_contacts=self.max_contacts,
            qfrc_applied=qfrc_applied, con_mu=runtime_con_mu(dm, state.geom_friction))

        invalid = invalid_contact(dm, fwd)
        terminated = invalid | self._out_of_bounds(qp)
        truncated = torch.zeros(B, dtype=torch.bool, device=dm.device)
        reward = torch.zeros(B, dtype=dm.dtype, device=dm.device)  # reference stub (:1141)

        time = state.time + m.timestep
        vel_steps = state.steps_until_resample_vel
        ref_lin_H, yaw_dot = state.ref_base_lin_vel_H, state.ref_base_ang_yaw_dot
        if self._lin_vel_table is not None or self._ang_vel_table is not None:
            table = self._lin_vel_table if self._lin_vel_table is not None \
                else self._ang_vel_table
            idx = torch.clamp(torch.round(time / self._vel_table_dt).long(), 0,
                              table.shape[0] - 1)
            if self._lin_vel_table is not None:
                ref_lin_H = self._lin_vel_table[idx]
            if self._ang_vel_table is not None:
                yaw_dot = self._ang_vel_table[idx]
        elif 'reset' in self.base_vel_command_type:
            new_lin, new_yaw, new_steps = self._sample_ref_vel(self._need(generator), B)
            hit = vel_steps <= 1
            ref_lin_H = torch.where(hit[:, None], new_lin, ref_lin_H)
            yaw_dot = torch.where(hit, new_yaw, yaw_dot)
            vel_steps = torch.where(hit, new_steps, vel_steps - 1)

        wrench, dist_steps = state.external_wrench, state.steps_until_resample_wrench
        kw = self.external_disturbances_kwargs
        if kw is not None and kw.get('type') == 'reset':
            new_wrench, new_steps = self._sample_disturbance(self._need(generator), B)
            hit = dist_steps <= 1
            wrench = torch.where(hit[:, None], new_wrench, wrench)
            dist_steps = torch.where(hit, new_steps, dist_steps - 1)

        new_state = EnvState(
            qpos=qp, qvel=qv, ctrl=ctrl, qacc=fwd.qacc, time=time,
            step_num=state.step_num + 1,
            ref_base_lin_vel_H=ref_lin_H, ref_base_ang_yaw_dot=yaw_dot,
            steps_until_resample_vel=vel_steps,
            external_wrench=wrench, steps_until_resample_wrench=dist_steps,
            geom_friction=state.geom_friction, sensors=state.sensors)
        new_state = self._step_sensors(new_state, state.qpos, state.qvel, fwd, generator)
        info = {'time': time, 'step_num': new_state.step_num,
                'invalid_contacts': invalid, 'culled_contacts': self._culled_contacts(fwd)}
        return new_state, self._obs(new_state, fwd), reward, terminated, truncated, info

    @staticmethod
    def _need(generator):
        if generator is None:
            raise ValueError("a 'reset' command or disturbance type resamples in step: "
                             'pass a generator')
        return generator

    def _culled_contacts(self, fwd):
        """(B,) int32: cone slots in contact beyond the max_contacts cap,
        which the solve left out; nonzero means the cap needs raising for
        this scene."""
        dm = self.model
        lay = constraint_layout(dm.m)
        cs = lay.cone_slots
        if len(cs) <= self.max_contacts:
            return torch.zeros(fwd.qacc.shape[0], dtype=torch.int32, device=dm.device)
        dist = fwd.contacts.dist[:, dm.const('cone_slots', lambda: cs)]
        touching = (dist < dm.const('cone_incl', lambda: lay.con_incl[cs])).sum(-1)
        return torch.clamp_min(touching - self.max_contacts, 0).to(torch.int32)

    def _out_of_bounds(self, qpos):
        """(B,) bool (quadruped_env.py:1250-1257)."""
        x_max, x_min, y_max, y_min = self.model.m.terrain_limits
        return ((qpos[:, 0] > x_max) | (qpos[:, 0] < x_min)
                | (qpos[:, 1] > y_max) | (qpos[:, 1] < y_min))

    def _step_sensors(self, state: EnvState, qpos_pre, qvel_pre, fwd, generator) -> EnvState:
        """Every sensor's state advanced by `Sensor.step` with the PRE-step
        (qpos, qvel) and the step's Forward: MuJoCo computes sensordata in
        mj_step's forward pass, so after a step it reflects the state before
        it (quadruped_env.py:273-274, imu.py:102)."""
        if not self.sensors:
            return state
        with record_function('sensors'):
            new = tuple(s.step(ss, qpos_pre, qvel_pre, fwd, generator)
                        for s, ss in zip(self.sensors, state.sensors))
        return dataclasses.replace(state, sensors=new)

    def _obs(self, state: EnvState, fwd) -> dict:
        core = [n for n in self.state_obs_names if self._sensor_of(n) is None]
        obs = obslib.compute_obs(self.model, core, state.qpos, state.qvel, state.ctrl, fwd,
                                 state.ref_base_lin_vel_H, state.ref_base_ang_yaw_dot)
        for name in self.state_obs_names:
            sensor = self._sensor_of(name)
            if sensor is not None:
                obs[name] = sensor.get_observation(name, state.sensors[self.sensors.index(sensor)])
        return {name: obs[name] for name in self.state_obs_names}
