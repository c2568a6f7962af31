#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --newton-agreement   # phases 1 and 5 alone
    python3 chip_smoke.py --terrain            # phases 1-2 and 35-41 alone
    python3 chip_smoke.py --sensors            # phases 1-2 and 42-46 alone
    python3 chip_smoke.py --mpc                # phases 1-2 and 47-50 alone
    python3 chip_smoke.py --robots             # phases 1-2 and 51-67 alone
    python3 chip_smoke.py --mixed              # phases 1-2 and 68-73 alone
    python3 chip_smoke.py --gym                # phases 1-2 and 74-78 alone
    python3 chip_smoke.py --tree               # phases 1-2, 79 and 80 alone
    python3 chip_smoke.py --examples           # phases 1-2 and 81 alone

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. the card: require CUDA, print `nvidia-smi` name and power limit, turn
     TF32 off for matmuls and cuDNN;
  2. build the kernels with nvcc for sm_90a, one nvcc for each source and
     size, all in parallel: csrc/spd_solve.cu for n = 18, 7 and 32 (the sizes
     of phase 3) and 21 (the joint tree's, phase 79) and csrc/newton_fused.cu
     for nv = 18 and 21 (print seconds and ptxas), and each kernel's
     residency per SM at the main path's sizes from the CUDA occupancy query;
  3. the SPD kernel against its plain version and a float64 solve on seeded
     SPD systems at (4096, 18), (4097, 18), (100, 7) and (64, 32);
  4. SPD timings at (4096, 18) with CUDA events: the kernel (launched
     through its C entry point with its arguments made once, since the
     Python wrapper's own host time per call now exceeds the kernel's),
     the wrapper, the plain version, torch.linalg.solve (yardstick only)
     and the memory/compute bound;
  5. the fused Newton kernel against its plain version (the eager
     `solver.solve` on the card) in both forms (per-env stopping and a fixed
     count), from a_smooth and from zeros, at B=4096 and B=4097, on three
     cases: seeded soft spot/flat contact states; the same with one hip
     joint of about a quarter of the envs set past its range (active and
     inactive joint-limit rows side by side); and those states with every
     row sliced away (ns = C = 0). The same iteration counts in all but a
     few envs, zero forces on inactive rows, repeated launches bitwise
     identical. With --newton-agreement this phase runs alone after phase 1
     and prints its failures instead of raising (exit code 1 if any), so that
     a copy of this script run in another checkout reads that checkout's
     kernel on the same seeded states. Where a later phase runs phase 5's
     checks on another model, it takes B=4097 on the soft states alone;
  6. the main path: spot/flat, B=4096, f32, 100 steps of `step_batched` from
     the keyframe with seeded U(-2, 2) torques and the qacc warm start; every
     state finite, contacts active, exactly 2 SPD and 1 Newton kernel
     launches per step;
  7. card against CPU: 8 envs stepped 20 times in f64 on the CPU through the
     same functions, from the card's states at steps 0 and 80; every env
     within 1e-3 in qpos of the card after the 20 steps (the line also
     counts envs whose active rows or slots differed from the card's). The
     f64 side of this and of every later card-against-CPU comparison runs
     in one of CPU_WORKERS spawned processes while the card goes on: its
     lines come, marked with their phase, when it is done, and its checks
     fail the run there;
  8. Newton timings on the main path's last step inputs, in both forms: the
     fused kernel (through its C entry point, as in phase 4, and through
     the wrapper), the eager `solver.solve` on the card (the previous Newton
     stage) and two bounds from the iterations the kernel ran: the dense
     count over every row at full width, and the count of what these inputs
     need, over the active rows and blocks and their nonzeros (the one the
     kernels line reports);
  9. a device profile of 1 step: busy share, kernel launches per step, host
     and device time of the step's stages (smooth, contacts and within it
     narrow_phase and assembly, newton, euler) and of the port's two
     kernels, top kernels; then each pair group of the narrow phase apart
     (time on the stream and on the host, tensor operations);
 10-14. go2/flat, the reference's headline configuration (1,180 elliptic
     cone slots of condim 3 and 6, culled to 32): the Newton kernel's
     residency at go2's sizes (nv 18, ns 24, C 32); on seeded soft go2/flat
     states, whose active blocks must include condim 3 and 6, the kernel,
     the eager f32 solve and the eager f64 solve at caps of 10 (the step's,
     where most envs stop unconverged) and 30, the kernel held to the eager
     f32 solve within a bar below the f32-f64 gap, then phase 5 at the cap
     of 30; then phases 6-9 on go2/flat: 100 steps at B=4096 (steps/s,
     exactly 2 SPD and 1 Newton launches per step, active rows and blocks
     at the last step, peak device memory), card against CPU, Newton
     timings, bound and residency on the last step's inputs, and the
     profile with the narrow phase by group;
 15-19. the same five phases on aliengo/flat (328 pyramidal condim-3 slots
     culled to 32: nv 18, ns 148, C 0). Phase 15 holds the kernel against
     the eager f32 and f64 solves at the step's cap of 10 on seeded soft
     states (the keyframe lowered by its clearance, then the feet U(0, 5)
     mm into the floor) and on states pressed 3 cm further (active
     pyramidal rows past row 64, the kernel's third word of active rows),
     then runs phase 5's checks with the pressed states among its cases.
     41 steps; the CPU comparison covers steps 40-60 alone (the card
     stepping its envs on past the main path): the feet start 12.7 mm
     above the floor and first touch it after ~25 steps, so steps 0-20
     hold no contact;
 20-24. the same on b2/flat (998 slots, cylinder hips: the plane-,
     sphere- and box-cylinder groups among the narrow phase's; ns 140),
     phase 20 on the soft states alone, 41 steps, the CPU comparison over
     steps 40-60 (the feet touch after ~30 steps);
 25-29. the same on hyqreal2/random_boxes (6,173 slots, 400 world boxes;
     ns 158), BASELINE cfg4's scene: phase 25 on the soft states alone, 20
     steps at B=4096, then 4 envs of the last state stepped 20 times more on
     the card and in f64 on the CPU (steps 20-40: the feet touch from step
     ~18);
 30. the env layer's main path: `QuadrupedEnv('go2', scene='flat', ...)`
     with a forward command and per-env friction U(0.5, 1.5), a random
     reset of B=4096 envs (the rounds of its lift out of contact), then 200
     `env.step` in f32 with seeded U(-2, 2) torques and the default
     observables: env-steps/s beside phase 11's bare step in this call, peak
     memory, exactly 2 SPD and 1 Newton launch per step (counts set to 0
     just before the steps, read just after), every state and observable
     finite, and one env.step reporting no more host synchronisations than
     its step_batched alone;
 31. 20 steps with all 31 observables: each finite and of its obs_dim; the
     share of feet in contact and the culled contacts; the observables'
     device and host ms;
 32. card against CPU: 8 envs of the card's state at step 100, moved along
     the floor to the origin, stepped 20 times through env.step on the card
     and in f64 on the CPU at a Newton cap of 30 (as phase 10), qpos within
     1e-3; printed beside it, at the step's cap of 10, the same from the
     moved states and from the main path's own at their spawn positions (up
     to 10 km out, where f32 resolves 0.5-1 mm);
 33. quarantine: NaN in qvel of 3 envs, one `quarantine_step`: exactly those
     reset, terminated and counted, the others as a plain env.step; its
     time against a plain env.step;
 34. the hyqreal2/random_boxes env (BASELINE cfg4) with a forward+rotate
     command: random reset, 5 steps at B=4096, env-steps/s, lift rounds,
     peak memory, every state finite;
 35-39. go2/perlin (BASELINE cfg2: 1,607 slots, the heightfield-sphere,
     -capsule and -box groups), the five phases of go2/flat from its start
     on the terrain: the keyframe starts buried in the perlin terrain, so
     it is lifted out by the env's rule (base z raised by 1.1 x the feet's
     deepest penetration until no foot slot is active) and lowered along
     the nearest foot's normal until that foot presses 1 mm into it
     (phase 35 prints both); the agreement's soft states are that start pressed U(0, 5) mm
     into the terrain (only the feet touch: condim-6 blocks); 21 steps,
     card against CPU from step 0, Newton timings, the profile
     with the three heightfield groups among the narrow phase's;
 40. go2/perlin's env with random velocity commands (heading U(-pi, pi),
     speed U(0, 1) m/s) and per-env friction: random reset (lift rounds),
     5 `env.step` at B=4096 beside phase 36's bare rate, 2 SPD + 1 Newton
     launches per step, no more host syncs than `step_batched`, peak
     memory, every state and observable finite;
 41. b2/perlin (the heightfield-cylinder group) and hyqreal2/perlin (72
     prisms per heightfield-box pair), 5 steps each at B=4096 from their
     start on the terrain: steps/s, peak memory, launches, finite, and each
     narrow-phase group's stream and host ms.
 42. BASELINE cfg3: `QuadrupedEnv('aliengo', scene='flat', sensors=(IMU,
     HeightMap))` (noise and bias rate 0.01, a 10 x 10 grid of 0.1 m), the
     example's six observables, per-env friction U(0.5, 1.5): a random reset
     of B=4096, 60 `env.step` with seeded U(-2, 2) torques and the
     generator, beside the same env without sensors from the same state in
     this call (env-steps/s; the sensors' ms per step); the profiler range
     `sensors` (host and device ms), peak memory; exactly 2 SPD and 1
     Newton launch per step, no more host syncs than the sensorless
     env.step, every observable finite and of its dim, height_map_z 0 on
     the floor, imu_acc of envs standing still (over 10 more steps) near
     +9.81 along the site's z; both kernels timed on the last step;
 43. card against CPU: 8 envs of phase 42 at step 50, the IMU's noise 0,
     moved to the origin, 20 env.steps on the card and in f64 on the CPU at
     a Newton cap of 30: qpos within 1e-3, height_map_z, imu_gyro and imu_acc
     within SENSOR_BARS; the cap-10 readings beside them;
 44. aliengo/perlin's env with IMU and HeightMap (random reset, 5 steps at
     B=4096: env-steps/s, peak memory), every env's height_map_z against
     the heightfield's height at the grid points; hyqreal2/random_boxes' env
     with HeightMap alone (409,600 rays against 100 boxes per step), 5
     steps; its reset draws phase 34's random pose (the same seed), whose
     lift out of contact (deterministic, 100 rounds) phase 34 kept;
 45. Camera(64 x 48, robotcam).render of all 4096 envs of phases 42 (flat)
     and 44 (perlin): ms per render, peak memory, depth finite and >= 0, seg
     ids in [-1, ngeom), the shares of pixels on the terrain and the robot;
     4 envs against CPU f64 (depth and point cloud on the pixels whose seg
     agrees, the share whose seg differs);
 46. the aliengo/flat env with Camera(auto_render=True, fps=30), 50 steps
     at B=4096: the renders against the reference's rule worked out on the
     host, 2 SPD + 1 Newton launches per step; rollout_with_sensors
     rendering every 17 steps over the same states gives the same depth.
 47. MPC solves at H=12: `CentroidalMPC.solve` on go2/flat at B=4096 by
     bench.py's recipe (feet fixed under the hips, the keyframe with 0.01
     noise, qvel 0.1 noise, t U(0, 1), 0.4 m/s forward): cold (30 ADMM
     iterations) and warm (10) solves/s from synchronised host medians,
     host and device ms, tensor operations and host syncs per solve (0),
     peak memory and the bound; each env's Newton-Schulz residual, again
     with TF32 globally on (the port pins full f32; the unpinned loop's
     reading beside it); the first-knot forces of 8 envs against the
     port's f64 CPU solve;
 48. the closed loop: go2/flat's `QuadrupedEnv` at B=4096 reset from the
     keyframe (joints U(-0.05, 0.05) rad), forward commands U(0.2, 0.6)
     m/s, 121 env.steps under the MPC (trot, period 0.5 s) with a replan
     every 5: exactly 2 SPD and 1 Newton launch per env.step and none in a
     tick, no host sync in a tick, at least 90% of the envs upright at the
     end; mean vx against the command, env-steps/s beside the bare
     env.step's, the tick's host and device ms, and the replan-rate rule of
     tests/test_mpc_gate.py (warm solves/s against env-steps/s / 5);
 49. card against CPU: 4 envs of phase 48 at step 100 stepped 20 times
     with 4 replans in f64 on the CPU, qpos within 1e-3; the torque gap per
     replan;
 50. MPPI on go2/flat at the reference's defaults (K=1024, H=24, sigma 2,
     a Newton cap of 4): two solves from the keyframe, the second from the
     shifted plan: s per solve, rollouts/s, launches per solve (24 Newton,
     48 SPD), peak memory; each updated plan's cost within 1.05 of its
     nominal's, 1 <= ess <= K; 8 rollouts against f64 on the CPU at caps of
     30 and 4.
51-65. go1/flat (51-55: ns 443, its 419 condim-1 slots one row each
     beside 32 culled cone blocks), mini_cheetah/flat (56-60: ns 402,
     pyramidal, mixed condims, unculled; the mesh groups) and
     hyqreal1/flat (61-65: the mesh groups), five phases each as go2's:
     the kernel, eager f32 and eager f64 solves at caps 10 and 30 and phase
     5's checks at 30 (both forms, B=4096 and 4097; hyqreal1's per-env form
     against rounding's own reading, `rounding_bars`); 21 steps at B=4096
     on go1, 5 on mini_cheetah, 31 on hyqreal1 (its window at 30..50, the
     card stepping its envs on past the main path, as mini_cheetah's)
     (2 SPD and 1 Newton launch per step); the card against the CPU's f64
     at a Newton cap of 30 (8 envs on go1, 4 on the mesh robots, whose f64
     mesh groups take seconds per step on the CPU), the cap-10 path
     printed beside it; Newton timings on the last step (residency: 2
     envs per SM at (443, 32), 4 at 402); the profile and the narrow phase
     by group.
 66. BASELINE cfg1: `QuadrupedEnv('mini_cheetah', scene='flat')` with a
     forward command and random actions, 10 env.steps at B=1 and 3 at
     B=4096 (~1 s each), each beside the bare step's rate in this call;
     launches per step, host synchronisations.
 67. go1/perlin, hyqreal1/perlin and mini_cheetah/perlin (ns 1,058, one env
     per block) at B=4096, 3, 2 and 2 steps from the start on the
     terrain (the mesh scenes take ~4 s per step); the
     last step's kernel against the eager f32 solve; each narrow-phase
     group's ms on the stream (the heightfield-mesh group's among them).
 68. BASELINE cfg5 (bench.py's recipe): `MixedQuadrupedEnv` of go2 2,048,
     aliengo 1,024 and mini_cheetah 1,024 on flat, obs qpos, qvel and
     contact_state: a random reset, then 3 chunks of 16 env.steps with
     seeded U(-2, 2) torques through `rollout_with_sensors`, a 16 x 16
     Camera on aliengo's robotcam shot on that group's qpos after each
     chunk: env-steps/s from `RateMeter` (a lap per chunk) beside each
     group's own rate alone at its batch, peak memory, exactly 6 SPD and 3
     Newton launches per step, no host sync in a step, every group finite
     and upright; the checkpoint after chunk 1 (phase 71); on the last
     step each group's Newton kernel against the eager f32 solve and the
     SPD kernel against its plain version, on the inputs the step gave
     them;
 69. chunk 1's steps again from the reset state (bitwise repeatable, else
     the gap and the operations PyTorch names as not repeatable), and each
     group's slice of the mixed state against its own homogeneous env,
     bit for bit (or within that gap);
 70. 4 envs of each group from step 32, at the origin, 20 steps at a
     Newton cap of 30 through a mixed env on the card in f32 and on the CPU
     in f64: qpos within 1e-3;
 71. the chunk-1 checkpoint (state tuple, generator state, camera readout)
     restored into a fresh mixed env bit for bit, chunk 2 resumed from it
     under phase 69's rule;
 72. each group's 48 steps written to an H5 file with `append_batch` (s,
     MiB), read back with `H5Reader` and `ProprioceptiveDataset` (x 5, y 1
     frames, loaded to the card): one batch equal to the recording (left
     out, with a line that says so, where h5py is not installed);
 73. a `profiling.trace` of 1 cfg5 step: its file and each group's
     env.step host and device ms.
 74. the single-env gym adapter, `QuadrupedGymEnv(robot='go2')` on the
     card: `reset(seed=0)`, 60 steps of U(-2, 2) torques (within the
     action bounds):
     steps/s beside its core's bare env.step at B=1 in this call, launches
     per step (2 SPD, 1 Newton) and per Forward refresh (1, 1), host
     synchronisations per step (the numpy returns cost one stream
     synchronisation); the SPD kernel (its time, torch.linalg.solve's and
     the bound) and the Newton kernel (`newton_timing`, at a cap of 30) on
     the last step's inputs at B=1; every accessor against the CPU's f64
     adapter at the same state moved to the origin (1e-4, and 1e-3 for
     those that read the Newton solve, beside a cap-3 control);
     `Camera.save` on the card (where PIL
     is installed);
 75-77. go2/ramp, go2/slippery and go2/stairs at B=4096 from starts on
     each scene's feature (`feature_start`): 20 steps (steps/s, peak
     memory, launches per step), the active slots against the world boxes
     and the envs touching one at every step (all at step 0, at least 95%
     at each later step; their pair friction), card
     against CPU f64 on 4 envs over steps 0-20 at a Newton cap of 30, the
     last step's Newton kernel against the eager f32 solve, each
     narrow-phase group's stream ms;
 78. parallel/ in one process on nccl: the mesh and `all_hosts_sum`, a
     `shard_env` rollout of go2/flat at B=4096 over 5 steps against the
     unsharded one and `MPPI.solve_sharded` against `solve` (K=1024, H=24,
     cap 4), both bit for bit; one card cannot show scaling.
 79. the general joint tree (models/fixtures/jointtree-flat.npz, read with
     the port's Model.load: a free base, a ball-jointed tail, per leg two
     hinges on one body and a sprung, limited slide joint; nq 23, nv 21):
     B=4096 in f32 from the keyframe raised 0.1 m with seeded joint offsets,
     100 steps of seeded U(-2, 2) torques (steps/s, peak memory, 2 SPD and
     1 Newton launch per step, every env finite; the feet and the tail
     land), after phase 5's checks of the Newton kernel at nv = 21 on the
     tree's soft states at a cap of 30; both kernels at nv = 21 against
     their plain versions on the last step's inputs (times, bounds,
     torch.linalg.solve's time at (4096, 21), residency); card against CPU
     f64 on 8 envs over steps
     60-80 (across the landing) at a Newton cap of 30, the reading and its
     ratio to the bar of 1e-3.
 80. the joint tree on random_pyramids (models/fixtures/
     jointtree-random_pyramids.npz, compiled by the port's `models.builder` from
     the tree's MJCF as go2's robot file, read with Model.load: 4 tiers
     about x = 3, 25 pairs: the feet and the tail against the floor and the
     boxes): B=4096 in f32 from `feature_start` (over the pyramid, dropped
     onto the tiers' tops and edges), 100 steps of seeded U(-2, 2) torques
     (steps/s, peak memory, 2 SPD and 1 Newton launch per step, every env
     finite, 95% of the envs on a tier at step 0 and feet on the tiers); each
     narrow-phase group's stream and host ms (box-sphere, and box-capsule
     through the CCD); both kernels at nv = 21 against their plain
     versions on the last step's inputs (times, bounds, torch.linalg.solve's
     time, residency); card against CPU f64 on 8 envs over steps 0-20 at a
     Newton cap of 30, the reading and its ratio to the bar of 1e-3.
 81. the example drives through their `main` on the card
     (gym_quadruped_tpu_torch/examples/): go2_mpc_locomotion at 1 s (500
     env.steps at B=1 from the keyframe, a cold solve and 100 warm
     replans): its own lines, steps/s and solves/s, launches per env.step
     (2 SPD, 1 Newton; counts set to 0 just before the drive, read just
     after) and host synchronisations per env.step, z, vx over the last 0.5
     s against the command and the contact flags, upright and finite; both
     kernels against their plain versions on one more step from its last
     state (the Newton kernel at go2's cap of 30, as phase 74);
     aliengo_with_sensors (aliengo/perlin, IMU, 10 x 10 heightmap, 20 steps,
     the 64 x 48 depth camera): the IMU's reading, the heightmap's and the
     depth image's ranges, both kernels against their plain versions on
     one more step from its last state (as go2's); the live plotter fed
     go2's torques and joint positions as tensors on the card, its children
     exiting with code 0 within their join timeout. The RGB path (mujoco;
     Camera.image in an interpreter of its own) and aliengo_dataset and
     dataset_reproduction (h5py) run where their package imports, and are
     left out with a line where it does not; the viewer needs a display.
Phases 8, 13, 18, 23 and 28 also hold the kernel against the eager f32
solve on the last step's inputs, on the envs both converged, and print
both f32 solves' distance there from an eager f64 solve.
Next to each time, rate and memory size the line gives the card's name
and power limit. Then come the seconds each phase took, the kernels' JSON
record on the line before the last (go2/perlin's fields prefixed
`go2_perlin_`, the new robots' `go1_`, `mini_cheetah_`, `hyqreal1_` and
`<robot>_perlin_`, cfg5's `cfg5_` and `cfg5_<robot>_`, the adapter's `gym_`
and `gym_b1_`, the scenes' `go2_<scene>_`, phase 78's `parallel_`, the
joint tree's `tree_` and on the pyramids `pyramids_`, the example drives'
`examples_`; `sizes_built` lists the sizes each kernel was built
for), and {"ok": true, "device": {...}} last. A run of some phases alone (a flag)
prints their fields on a line of its own, then the same last line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import math
import socket
import subprocess
import sys
import time
import warnings
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils._python_dispatch import TorchDispatchMode

from gym_quadruped_tpu_torch.data import ProprioceptiveDataset
from gym_quadruped_tpu_torch.env import ALL_OBS, MixedQuadrupedEnv, QuadrupedEnv
from gym_quadruped_tpu_torch.env import observables as obslib
from gym_quadruped_tpu_torch.env.batch import bad_state_mask, quarantine_step, rollout_with_sensors
from gym_quadruped_tpu_torch.env.state import tensor_fields
from gym_quadruped_tpu_torch.examples.go2_mpc_locomotion import tick as mpc_tick
from gym_quadruped_tpu_torch.models.model import (
    GEOM_BOX,
    GEOM_HFIELD,
    JOINT_TREE,
    JOINT_TREE_PYRAMIDS,
    Model,
    load_model,
    to_device,
)
from gym_quadruped_tpu_torch.models.scene_starts import feature_start, world_box_slots
from gym_quadruped_tpu_torch.mpc import (
    MPPI,
    CentroidalMPC,
    GaitConfig,
    MPCConfig,
    MPPIConfig,
    velocity_tracking_cost,
)
from gym_quadruped_tpu_torch.mpc import qp
from gym_quadruped_tpu_torch.mpc.centroidal import NX
from gym_quadruped_tpu_torch.ops import newton_fused as nf
from gym_quadruped_tpu_torch.ops import spd_solve as spd
from gym_quadruped_tpu_torch.parallel import distributed as pdist
from gym_quadruped_tpu_torch.parallel import rollout, shard_env
from gym_quadruped_tpu_torch.physics import collision, constraints, engine, kinematics, solver
from gym_quadruped_tpu_torch.physics.constraints import (
    constraint_layout,
    culled_pyramidal,
    pyramidal_rows,
    runtime_con_mu,
    simple_slot_rows,
)
from gym_quadruped_tpu_torch.physics.forces import feet_slot_mask
from gym_quadruped_tpu_torch.physics.raycast import world_geoms
from gym_quadruped_tpu_torch.sensors import IMU, Camera, HeightMap
from gym_quadruped_tpu_torch.utils import checkpoint, profiling
from gym_quadruped_tpu_torch.utils.data import H5Reader, H5Writer
from gym_quadruped_tpu_torch.utils.profiling import RateMeter
from gym_quadruped_tpu_torch.utils.tree import leaves_with_path

SEED = 0
BATCH = 4096
STEPS = 200
N_CPU_ENVS = 8
CPU_STEPS = 20
# go2/flat's env steps (phase 30): phase 32's window runs from its step 100
ENV_STEPS = 100 + CPU_STEPS + 1
# H100 SXM published peaks: HBM bytes/s, f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# the fused kernel against the eager solve: relative to 1 + max|reference|
NEWTON_BAR = 1e-4
# Iteration counts against the eager solve. The two f32 solves round apart by
# ~3e-7 of 1 + max|qacc|, the order of the converged step (tol 1e-6 of the
# same), so an env near convergence may stop one iteration apart either way
# (about 1% of the envs, with this kernel and with the one-block-per-env
# kernel it replaced; PERF.md): at most 2% of the envs may differ, and the
# mean by at most 0.01.
ITERATION_ENVS_BAR = 0.02
ITERATION_MEAN_BAR = 0.01
# go2/flat's soft states take more Newton iterations from a_smooth than the
# step's cap of 10 allows: at that cap 3,267 of 4,096 envs stop unconverged,
# and rounding alone moves the eager solve by 2.8e-1 of 1 + max|qacc| (f32
# against f64 at the same tolerance, phase 10), where the kernel ends 1.7e-2
# from the eager f32 solve (NVIDIA H100, PERF.md). At the cap of 10 the
# kernel is held within 5e-2 of the eager f32 solve on every env, within
# NEWTON_BAR on the envs both converged, and to ITERATION_ENVS_BAR. At a cap
# of 30 both converge and phase 5's checks apply, with an envs bar of 5%:
# there the eager f32 and f64 solves stop at another iteration in 3.6% of
# the envs, the kernel and the eager f32 solve in 3.5%.
GO2_CAP10_BAR = 5e-2
GO2_AGREEMENT_ITERATIONS = 30
GO2_ITERATION_ENVS_BAR = 0.05
# The pyramidal models' agreement states (phases 15, 20 and 25): soft, and
# for aliengo pressed 3 cm further into the floor. At the step's cap of 10
# all but at most 20 of 4,096 envs converge (3-6 iterations per env on
# average), and rounding alone moves the eager solve by 9.3e-08-1.3e-07 of 1 +
# max|qacc| on aliengo's and b2's states, 9.9e-08-7.1e-07 on hyqreal2's (f32
# against f64 at the f32 tolerance), where the kernel ends 1.40e-07-1.54e-07
# (aliengo), 9.8e-08 (b2) and 9.8e-08-6.9e-07 (hyqreal2) from the eager f32
# solve (NVIDIA H100 80GB HBM3, 700 W, PERF.md). The kernel is held within
# 1e-6 of the eager f32 solve on every env: the f32 tolerance on the
# converged step.
PRESS = 0.03
PYR_CAP10_BAR = 1e-6
LS_ITERATIONS = 6
# median_ms: a timed window of back-to-back calls lasts about this long (a
# kernel of 1-3 ms takes 7-20 calls, one of 0.01 ms the cap of 100; a plain
# solve of 100 ms one)
TIMING_WINDOW_MS = 20.0


def contact_rows(lay, K=None):
    """The simple contact rows `make_efc` emits: those of the culled
    pyramidal slots, or the unculled per-slot rows (go1's condim-1 slots,
    mini_cheetah's mixed condims)."""
    if culled_pyramidal(lay) or not len(lay.simple_con_slots):
        _, per_slot, kept = pyramidal_rows(lay, K)
        return per_slot * kept
    return len(simple_slot_rows(lay)[0])


def newton_sizes(m):
    """(nv, ns, C) of the Newton kernel's inputs on model m's step: the
    friction-loss and limit rows, the simple contact rows (`contact_rows`),
    and the culled cone blocks."""
    lay = constraint_layout(m)
    K = engine.MAX_CONE_CONTACTS
    return m.nv, lay.n_fl + lay.n_lim + contact_rows(lay, K), min(len(lay.cone_slots), K)


# the sizes phase 2 builds each kernel for: spot's and every compiled robot's
# nv of 18, phase 3's 7 and 32, the joint tree's 21 (phase 79)
SPD_SIZES = (18, 7, 32, 21)
NEWTON_SIZES = (18, 21)

T_START = time.perf_counter()
LOGGED = {}   # phase: the time of its last line


def log(phase, msg, late=False):
    """Print a phase's line; `late` for a line of a comparison finished
    after its phase (`drain`), which leaves the phase's seconds alone."""
    print(f'[{phase}] {msg}', flush=True)
    if not late:
        LOGGED[phase] = time.perf_counter()
        drain(block=False)


# ---- the CPU's f64 side of the card-against-CPU comparisons ---------------------------
# It needs no card: it runs in CPU_WORKERS spawned processes (one thread
# each) while this process drives the card on. `later` queues a job and
# what finishes it here (its lines, marked late, and its checks); `drain`
# runs the finishes of the jobs that are done, in the order queued, and at
# the end of a run waits for every one. A failed check raises there and
# fails the run as it did in its phase.
CPU_WORKERS = 4
_POOL = []       # the executor, made at the first job
_PENDING = []    # (future, finish(result))


def later(job, args, finish):
    if not _POOL:
        _POOL.append(ProcessPoolExecutor(CPU_WORKERS, multiprocessing.get_context('spawn'),
                                         initializer=one_thread))
    _PENDING.append((_POOL[0].submit(job, *args), finish))


def later_all(jobs, finish):
    """`later` for several (job, args): finish(their results, in order) once
    the last is done."""
    results = []
    for i, (job, args) in enumerate(jobs):
        last = i == len(jobs) - 1
        later(job, args, lambda r, last=last: results.append(r) or (last and finish(results)))


def one_thread():
    torch.set_num_threads(1)   # tiny batched products: one thread is fastest


def drain(block=True):
    while _PENDING and (block or _PENDING[0][0].done()):
        future, finish = _PENDING.pop(0)
        finish(future.result())   # its lines are late: they drain nothing


def stop_workers():
    """End the CPU workers, a job still running among them."""
    if _POOL:
        pool = _POOL.pop()
        processes = list((pool._processes or {}).values())
        pool.shutdown(wait=False, cancel_futures=True)
        for proc in processes:
            proc.terminate()
            proc.join()


@functools.cache
def cpu_model(spec):
    """The CPU's f64 model: `spec` (robot, scene) for its compiled archive,
    or an archive's path."""
    if isinstance(spec, tuple):
        return load_model(*spec, device='cpu', dtype=torch.float64)
    return to_device(Model.load(spec), 'cpu', torch.float64)


def cpu_window(spec, start, ctrls, acts, cap):
    """A worker's job: `spec`'s envs stepped in f64 from `start` (qpos,
    qvel, warm start) with `ctrls`, at a Newton cap of `cap` (None: the
    step's). Returns the final qpos and, per env, whether its active rows
    or slots differed from `acts` (the card's) at some step."""
    dm64 = cpu_model(spec)
    C_all = len(constraint_layout(dm64.m).cone_slots)
    iters = {} if cap is None else {'solver_iterations': cap}
    q, v, w = start
    switched = torch.zeros(q.shape[0], dtype=torch.bool)
    for ctrl, act in zip(ctrls, acts):
        q, v, f = engine.step_batched(dm64, q, v, ctrl, warmstart=w, **iters)
        w = f.qacc
        switched |= (activation(f.efc, C_all) != act).any(1)
    return q, switched


def cpu_env_steps(robot, scene, kwargs, state, actions, sensors=False):
    """A worker's job: `state` stepped in f64 through env.step of an env of
    `robot` on `scene` made with `kwargs` (`cfg3_env`'s with `sensors`,
    else `QuadrupedEnv`'s), with `actions`. Returns the final state and
    each step's observations."""
    dm64 = cpu_model((robot, scene))
    env = cfg3_env(dm64, **kwargs) if sensors else QuadrupedEnv(robot, model=dm64, **kwargs)
    obs = []
    for a in actions:
        state, o = env.step(state, a)[:2]
        obs.append(o)
    return state, obs


def cpu_mixed_steps(groups, kwargs, states, actions):
    """A worker's job: `states` (one per group) stepped in f64 through a
    mixed env of `groups` ((robot, envs) on flat) made with `kwargs`, with
    `actions`. Returns the final states."""
    env = MixedQuadrupedEnv([(r, n, {'model': cpu_model((r, 'flat'))}) for r, n in groups],
                            scene='flat', **kwargs)
    for a in actions:
        states = env.step(states, a)[0]
    return states


def cpu_mppi_costs(cfg, caps, qpos, qvel, ctrls):
    """A worker's job: go2/flat's MPPI rollout costs of `ctrls` in f64 at
    each Newton cap of `caps` (phase 50's cost)."""
    dm64 = cpu_model(('go2', 'flat'))
    cost = velocity_tracking_cost(dm64, (0.4, 0.0, 0.0), 0.0, float(dm64.m.key_qpos[0][2]))
    return {c: MPPI(dm64, cost, dataclasses.replace(cfg, solver_iterations=c))._rollout_cost(
        qpos, qvel, ctrls) for c in caps}


def phase_seconds():
    """The seconds each phase took, from the last line of the phase before
    to its own last line."""
    out, t0 = {}, T_START
    for phase, t in LOGGED.items():
        out[phase] = round(t - t0, 1)
        t0 = t
    return out


def random_spd(gen, B, n):
    X = torch.randn(B, n, n, generator=gen, device='cuda')
    A = X @ X.transpose(1, 2) + n * torch.eye(n, device='cuda')
    b = torch.randn(B, n, generator=gen, device='cuda')
    return A.contiguous(), b


def median_ms(fn, launches=100, repeats=7, warmup=5):
    """Median over `repeats` of the mean time of back-to-back calls, timed
    with CUDA events after `warmup` calls: as many calls as fill
    TIMING_WINDOW_MS by the time of one, at least one and at most
    `launches`."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    launches = max(1, min(launches, math.ceil(TIMING_WINDOW_MS / max(start.elapsed_time(end),
                                                                     1e-3))))
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def rel_err(x, ref):
    return ((x.double() - ref.double()).abs().max() / (1 + ref.double().abs().max())).item()


def bound(n_bytes, n_flop):
    """(bound ms, 'bytes' or 'operations'): the larger of the two times."""
    t_bytes, t_flop = n_bytes / HBM_BYTES_PER_S, n_flop / F32_FLOP_PER_S
    return max(t_bytes, t_flop) * 1e3, 'bytes' if t_bytes >= t_flop else 'operations'


def on_terrain(m):
    """The scene has a heightfield: its keyframe starts buried in it."""
    return bool((m.geom_type == GEOM_HFIELD).any())


@functools.lru_cache(maxsize=None)
def start_qpos(dm):
    """(the start qpos (nq,), how far the lift raised the base, how far it
    was lowered after, the lift's rounds): the keyframe; on a heightfield
    the keyframe lifted out of the terrain by the env's rule (base z raised
    by 1.1 x the feet's deepest penetration until no foot slot is active),
    then lowered onto it: by the nearest foot slot's distance over its
    normal's z and 1 mm more, so that this foot presses 1 mm into the
    terrain (at exactly touching, its activation would be rounding's)."""
    key = torch.as_tensor(dm.m.key_qpos[0], dtype=dm.dtype, device=dm.device)
    if not on_terrain(dm.m):
        return key, 0.0, 0.0, 0
    env = QuadrupedEnv(dm.m.robot, scene=dm.m.scene, model=dm)
    lifted, rounds = env._lift_until_no_contact(key[None])
    foot = torch.as_tensor(np.any(feet_slot_mask(dm.m) > 0, axis=0), device=dm.device)
    con = collision.collide(dm, kinematics.fk(dm, lifted))
    dist = torch.where(foot, con.dist[0], torch.inf)
    i = int(dist.argmin())
    lower = max(0.0, dist[i].item() / con.normal[0, i, 2].item()) + 0.001
    qpos = lifted[0].clone()
    qpos[2] -= lower
    return qpos, (lifted[0, 2] - key[2]).item(), lower, rounds


def clearance(dm):
    """How far the start's nearest contact slot is from touching (0 when it
    touches): aliengo's feet stand 12.7 mm above the floor, b2's 17.9 mm,
    hyqreal2's 6.1 mm; spot's and go2's press into it."""
    kin = kinematics.fk(dm, start_qpos(dm)[0][None])
    return max(0.0, collision.collide(dm, kin).dist.min().item())


def soft_state(dm, gen, B, limits=False, press=0.0):
    """M, a_smooth and the rows of B seeded soft contact states: the start
    (`start_qpos`: the keyframe, on a heightfield lifted out of the terrain)
    lowered by its clearance, then `press` and U(0, 5) mm more into the
    floor or terrain, qvel 0, U(-0.5, 0.5) torques. With `limits`, the first
    limited joint (a hip) of about a quarter of the envs sits 0.01 rad past
    the top of its range (mini_cheetah's joints have no limits: its states
    stay soft)."""
    m = dm.m
    qpos = start_qpos(dm)[0].repeat(B, 1)
    qpos[:, 2] -= clearance(dm) + press + 0.005 * torch.rand(B, generator=gen, device='cuda')
    ctrl = torch.rand(B, m.nu, generator=gen, device='cuda') - 0.5
    if limits and len(constraint_layout(m).lim_jnts):
        j = constraint_layout(m).lim_jnts[0]
        past = torch.rand(B, generator=gen, device='cuda') < 0.25
        qpos[past, int(m.jnt_qposadr[j])] = float(m.jnt_range[j, 1]) + 0.01
    fwd = engine.forward(dm, qpos, torch.zeros(B, m.nv, device='cuda'), ctrl)
    return fwd.M, fwd.qacc_smooth, fwd.efc


def without_rows(efc):
    """The same Efc with every simple row and cone block sliced away."""
    return dataclasses.replace(efc, **{f.name: getattr(efc, f.name)[:, :0].contiguous()
                                       for f in dataclasses.fields(efc)
                                       if getattr(efc, f.name) is not None})


def newton_flop(nv, ns, C, env_iterations, B, ls=LS_ITERATIONS):
    """Floating-point operations of a dense Newton solve, which ignores the
    data: every simple row and cone block active, every product over all its
    entries. Per env and iteration, times the iterations the envs ran, plus
    the final forces once per env."""
    rows = ns + 6 * C
    chol = sum(2 + (nv - 1 - j) + (nv - 1 - j) * (nv - j) for j in range(nv))
    per_iteration = (
        rows * (2 * nv + 1) + nv                                # rows, a - a_smooth
        + 12 * ns + 340 * C                                     # forces, curvatures
        + nv * (2 * nv + 2 * rows + 2)                          # g
        + 6 * C * nv * 12                                       # Hc cJ
        + nv * (nv + 1) // 2 * (3 * ns + 12 * C + 2) + nv       # H, lower triangle
        + chol + 2 * nv * nv + nv                               # Cholesky, solves
        + 2 * nv * nv + 2 * nv * rows + 4 * nv                  # M p, J p, p'M p, p'M r
        + (15 + ls) * (10 * ns + 84 * C + 6) + 30 + 4 * nv + 2)  # line search, update
    final = rows * (2 * nv + 1) + 6 * ns + 60 * C + 2 * nv * rows
    return env_iterations * per_iteration + B * final


def newton_needed_work(M, efc, iterations, ls=LS_ITERATIONS):
    """(FLOP, bytes) that these inputs need. FLOP: per env and iteration,
    times the iterations it ran, plus its final forces, with every product
    counted over the entries it needs: the active simple rows, the unmasked
    rows (cone_dim_mask) of the active cone blocks, the nonzeros of each such
    row of J, the nonzeros of M, and in H the pairs of dofs that one such row
    or block touches (a simple row of one nonzero adds to one diagonal
    entry). The Cholesky is counted dense: under the dofs' order its factor
    fills in. Bytes: M, a_smooth, the warm start, the masks, the grid, the
    active rows' inputs and every output, each once."""
    f64 = torch.float64
    B, nv = M.shape[0], M.shape[1]
    na = efc.active.sum(1).to(f64)
    nc = efc.con_active.sum(1).to(f64)
    s = ((efc.J != 0).sum(2) * efc.active).to(f64)            # nonzeros per simple row
    rows = efc.con_active[:, :, None] & (efc.cone_dim_mask != 0)   # needed cone rows
    nz = (efc.con_J != 0) & rows[..., None]
    dc = rows.sum(2).to(f64)                                     # needed rows per block
    kc = nz.any(2).sum(2).to(f64)                                # dofs per block
    S = s.sum(1) + nz.sum((1, 2, 3)).to(f64)                     # nonzeros of needed rows
    R = na + dc.sum(1)                                           # needed rows
    nzM = (M != 0).sum((1, 2)).to(f64)
    chol = sum(2 + (nv - 1 - j) + (nv - 1 - j) * (nv - j) for j in range(nv))
    per_iteration = (
        2 * S + R + nv                                           # rows, a - a_smooth
        + 12 * na + 340 * nc                                     # forces, curvatures
        + 2 * nzM + 2 * S + 2 * nv                               # g
        + (2 * dc * dc * kc).sum(1)                              # Hc cJ
        + (3 * s * (s + 1) / 2).sum(1)                           # J' diag(cw) J
        + (dc * kc * (kc + 1)).sum(1) + 2 * nv                   # cJ' Hc cJ, M + ., reg
        + chol + 2 * nv * nv + nv                                # Cholesky, solves
        + 2 * nzM + 2 * S + 4 * nv                               # M p, J p, p'M p, p'M r
        + (15 + ls) * (10 * na + 84 * nc + 6) + 30 + 4 * nv + 2)  # line search, update
    final = 4 * S + R + 6 * na + 60 * nc
    flop = (iterations.to(f64) * per_iteration + final).sum().item()
    ns, C = efc.J.shape[1], efc.con_J.shape[1]
    floats = (B * (nv * nv + 2 * nv) + 15 + na.sum().item() * (nv + 3)
              + nc.sum().item() * (6 * nv + 6 + 6 + 5 + 6)       # inputs
              + B * (2 * nv + ns + 6 * C))                         # outputs
    return flop, 4 * floats + B * (ns + C)


def newton_agreement(dm, phase=5, iterations=10, envs_bar=ITERATION_ENVS_BAR, press=None,
                     rounding=False, limits=True, odd_all=False):
    """Phases 5, 10 and 15: the fused Newton kernel against the eager
    `solver.solve` on the card, both with a cap of `iterations`; with
    `press`, also on soft states pressed that much further into the floor.
    With `rounding` (`ROUNDING_ROBOTS`), the bars are referenced to what
    rounding alone does (`rounding_bars`); without `limits`, the case of a
    hip past its range is left out. At B=4097 (a last block part full) the
    soft case alone, every case with `odd_all` (phase 5).
    Returns (the max abs qacc difference of the soft B=4096 per-env case from
    a_smooth, the bars each case failed, the set of cone dimensions among
    the active blocks of the soft states)."""
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    newton_abs_err = None
    failures = []
    soft_dims = set()
    forms = (('solve_batched', nf.solve_batched, None),
             ('solve_batched_bt', nf.solve_batched_bt, 0.0))
    for B in (BATCH, BATCH + 1):
        soft = soft_state(dm, gen, B)
        soft_dims |= set(soft[2].cone_dim_mask.sum(-1)[soft[2].con_active].int().tolist())
        cases = (('soft', *soft),)
        if B == BATCH or odd_all:
            M, a_s, efc = soft_state(dm, gen, B, limits=True)
            cases += (((('active limits', M, a_s, efc),) if limits else ())
                      + (('ns = C = 0', M, a_s, without_rows(efc)),))
            if press is not None:
                cases += ((f'pressed {press * 100:g} cm', *soft_state(dm, gen, B, press=press)),)
        for case, M, a_s, efc in cases:
            rows = efc.active.nonzero()[:, 1]
            log(phase, f'{dm.m.robot}/{dm.m.scene} B={B} {case}: ns={efc.J.shape[1]}, '
                       f'C={efc.con_J.shape[1]}, active simple rows per env '
                       f'{efc.active.sum(1).float().mean().item():.3f} (the last active one '
                       f'row {int(rows.max()) if rows.numel() else None}), active cone blocks '
                       f'per env {efc.con_active.sum(1).float().mean().item():.3f}')
            for form, fn, tol in forms:
                for start, warm in (('a_smooth', None), ('zeros', torch.zeros_like(a_s))):
                    it = torch.zeros(B, dtype=torch.int32, device='cuda')
                    got = fn(M, a_s, efc, warmstart=warm, iterations=iterations,
                             iterations_out=it)
                    again = fn(M, a_s, efc, warmstart=warm, iterations=iterations)
                    torch.cuda.synchronize()
                    it_ref = torch.zeros_like(it)
                    ref = solver.solve(M, a_s, efc, warm, iterations, iterations_out=it_ref,
                                       _tol=tol)
                    errs = [rel_err(g, r) if r.numel() else 0.0 for g, r in zip(got, ref)]
                    held = None
                    if rounding and efc.J.shape[1] + efc.con_J.shape[1]:
                        it_64 = torch.zeros_like(it)
                        with mock.patch.object(solver, 'spd_solve_batched',
                                               spd.unrolled_chol_solve_torch):
                            ref64 = solver.solve(
                                M.double(), a_s.double(), as_f64(efc),
                                None if warm is None else warm.double(), iterations,
                                iterations_out=it_64,
                                _tol=solver._TOL[torch.float32] if tol is None else tol)
                        held = rounding_bars(got, ref, ref64, it, it_ref, it_64,
                                             f'{dm.m.robot}/{dm.m.scene} B={B} {case} {form} '
                                             f'from {start}', phase)
                    same = all(torch.equal(x, y) for x, y in zip(got, again))
                    n_diff = int((it != it_ref).sum())
                    zeros = bool((got[1][~efc.active] == 0).all()
                                 and (got[2][~efc.con_active] == 0).all())
                    log(phase, f'B={B} {case} {form} from {start}: rel err vs plain qacc '
                           f'{errs[0]:.3e}, f_simple {errs[1]:.3e}, f_cone {errs[2]:.3e}, qfrc '
                           f'{errs[3]:.3e}; max|qacc| {ref[0].abs().max().item():.2f}; mean '
                           f'iterations kernel {it.float().mean().item():.3f}, plain '
                           f'{it_ref.float().mean().item():.3f} (max {int(it_ref.max())}), '
                           f'envs that differ {n_diff}; '
                           f'zero forces on inactive rows {zeros}; repeat bitwise equal {same}')
                    # soft states converge in f32; the bar is 1e-4 of 1 + max|ref|
                    where = f'{dm.m.robot} B={B} {case} {form} from {start}'
                    mean_diff = abs(it.float().mean() - it_ref.float().mean()).item()
                    if held is not None:
                        failures += [f'{f}: {where}' for f in held]
                    elif not max(errs) < NEWTON_BAR:
                        failures.append(f'Newton kernel disagrees: {where}')
                    if held is None and (n_diff > envs_bar * B
                                         or mean_diff > ITERATION_MEAN_BAR):
                        failures.append(f'Newton iteration counts differ in {n_diff} envs, '
                                        f'mean by {mean_diff}: {where}')
                    if not zeros:
                        failures.append(f'Newton kernel forces on inactive rows: {where}')
                    if not same:
                        failures.append(f'Newton kernel not deterministic: {where}')
                    if (B, case, form, start) == (BATCH, 'soft', 'solve_batched', 'a_smooth'):
                        newton_abs_err = (got[0] - ref[0]).abs().max().item()
    log(phase, f'cone dimensions among the active blocks of the soft states: {sorted(soft_dims)}')
    return newton_abs_err, failures, soft_dims


def as_f64(efc):
    """The same Efc with every float tensor in float64."""
    return dataclasses.replace(efc, **{
        f.name: getattr(efc, f.name).double() for f in dataclasses.fields(efc)
        if getattr(efc, f.name) is not None and getattr(efc, f.name).is_floating_point()})


def three_solves(dm, M, a_s, efc, label, phase, caps, cap10_bar, rounding=False):
    """At each cap and in both forms, three solves of the same inputs: the
    kernel, the eager f32 solve and the eager f64 solve at the f32
    tolerance. The f32-f64 gap is what rounding alone does to the eager
    solve; the kernel is held to the eager f32 solve within NEWTON_BAR on
    the envs both f32 solves converged and, at the step's cap of 10, within
    `cap10_bar` on every env and to ITERATION_ENVS_BAR. With `rounding`
    (`ROUNDING_ROBOTS`), the bars of `rounding_bars` instead. Returns (the
    bars failed, the max abs qacc difference of the kernel's first solve from
    the eager f32 one)."""
    B = a_s.shape[0]
    M64, a64, efc64 = M.double(), a_s.double(), as_f64(efc)
    failures = []
    abs_err = None
    for cap in caps:
        for form, fn, tol in (('solve_batched', nf.solve_batched, solver._TOL[torch.float32]),
                              ('solve_batched_bt', nf.solve_batched_bt, 0.0)):
            it_k, it_32, it_64 = (torch.zeros(B, dtype=torch.int32, device='cuda')
                                  for _ in range(3))
            got = fn(M, a_s, efc, iterations=cap, iterations_out=it_k)
            ref = solver.solve(M, a_s, efc, iterations=cap, iterations_out=it_32, _tol=tol)
            # the SPD kernel takes f32 only: the f64 solve's SPD solves run plain
            with mock.patch.object(solver, 'spd_solve_batched', spd.unrolled_chol_solve_torch):
                ref64 = solver.solve(M64, a64, efc64, iterations=cap, iterations_out=it_64,
                                     _tol=tol)
            gap_k, gap_32 = rel_err(got[0], ref[0]), rel_err(ref[0], ref64[0])
            if abs_err is None:
                abs_err = (got[0] - ref[0]).abs().max().item()
            n_k, n_32 = int((it_k != it_32).sum()), int((it_32 != it_64).sum())
            done = (it_k < cap) & (it_32 < cap)        # envs both f32 solves converged
            gap_done = rel_err(got[0][done], ref[0][done]) if bool(done.any()) else 0.0
            log(phase, f'{label} B={B}, cap {cap}, {form}: qacc kernel vs '
                       f'eager f32 {gap_k:.3e}, eager f32 vs eager f64 {gap_32:.3e}, kernel vs '
                       f'eager f64 {rel_err(got[0], ref64[0]):.3e} (of 1 + max|qacc|), kernel vs '
                       f'eager f32 on the {int(done.sum())} envs both converged {gap_done:.3e}; envs '
                       f'whose iteration count differs: kernel vs f32 {n_k}, f32 vs f64 {n_32}; '
                       f'mean iterations kernel {it_k.float().mean().item():.3f}, f32 '
                       f'{it_32.float().mean().item():.3f}, f64 {it_64.float().mean().item():.3f}; '
                       f'envs at the cap (f32) {int((it_32 == cap).sum())}')
            # where the gap lies: the envs past the bar's absolute size, and
            # the worst env's iterations and distance from f64 on each side
            env_gap = (got[0] - ref[0]).abs().amax(1)
            scale = 1.0 + ref[0].abs().max().item()
            w = int(env_gap.argmax())
            e64 = lambda x: (x[w].double() - ref64[0][w]).abs().max().item() / scale
            log(phase, f'{label} B={B}, cap {cap}, {form}: envs past {NEWTON_BAR:g} of 1 + '
                       f'max|qacc| {int((env_gap > NEWTON_BAR * scale).sum())}; the worst env '
                       f'{w}: iterations kernel {int(it_k[w])}, f32 {int(it_32[w])}, f64 '
                       f'{int(it_64[w])}, from f64 kernel {e64(got[0]):.3e}, eager f32 '
                       f'{e64(ref[0]):.3e}')
            where = f'{label} B={B} cap {cap} {form}'
            if rounding:
                failures += [f'{f}: {where}' for f in rounding_bars(
                    got, ref, ref64, it_k, it_32, it_64, f'{label} B={B}, cap {cap}, {form}',
                    phase)]
                continue
            if not gap_done < NEWTON_BAR:
                failures.append(f'Newton kernel disagrees on converged envs: {where}')
            if cap == 10 and not (gap_k < cap10_bar and n_k <= ITERATION_ENVS_BAR * B):
                failures.append(f'Newton kernel off by {gap_k} in qacc, {n_k} envs in '
                                f'iterations at the cap of 10: {where}')
    return failures, abs_err


# Robots whose soft states sit at the f32 stopping rule's edge: on
# hyqreal1/flat's, the eager f32 and f64 solves stop at another iteration in
# 622 of 4,096 envs (15%) at the cap of 30, and at the cap of 10 (2,520 envs
# unconverged) rounding alone moves the eager solve by 2.6e-1 of 1 +
# max|qacc|; one env in 4,096 (env 949) stops one iteration apart with a step
# below the tolerance whose next step moves qacc 1.0e-4 (the stopping rule
# tests the step t p, and a small line-search t passes it); and its heavy
# stiff cone blocks turn f32 rounding in J a - aref into cone forces 5e-4 of
# 1 + max|f| apart (kernel against eager f32, the fixed-count form, where
# qacc agrees to 7e-7). NVIDIA H100 80GB HBM3, 700.00 W, PERF.md. There the
# kernel is held to f64 as the plain f32 solve is (`rounding_bars`), and
# phase 5's case of a hip 0.01 rad past its range is left out: f32 resolves
# those limit forces to no better than 8.4e-07-2.5e-02 of 1 + max|f| (the
# eager f32 solve against f64 over 8 solves of the case), so neither solve
# is a yardstick for the other there.
ROUNDING_ROBOTS = ('hyqreal1',)
ROUNDING_COUNT_SLACK = 1.25
ROUNDING_ERR_SLACK = 2.0


def rounding_bars(got, ref, ref64, it_k, it_32, it_64, label, phase):
    """The bars of a robot of ROUNDING_ROBOTS on the kernel's outputs `got`
    (qacc, f_simple, f_cone, qfrc), the eager f32 solve's `ref` and the eager
    f64 solve's `ref64`, with their iteration counts: on the envs where all
    three stop at the same iteration (the same Newton steps), each output of
    the kernel within ROUNDING_ERR_SLACK x the eager f32 solve's distance
    from f64, or NEWTON_BAR of 1 + max|f64| (the kernel as accurate as the
    plain f32 solve); and the kernel stops at another iteration than the
    eager f32 solve in at most ROUNDING_COUNT_SLACK x the envs where rounding
    alone does so (eager f32 against eager f64), or ITERATION_ENVS_BAR of
    them. Returns the bars failed."""
    B = it_k.shape[0]
    same = (it_k == it_64) & (it_32 == it_64)
    n_k, n_32 = int((it_k != it_32).sum()), int((it_32 != it_64).sum())
    count_bar = max(ITERATION_ENVS_BAR * B, ROUNDING_COUNT_SLACK * n_32)
    failures, parts = [], []
    for name, g, r, r64 in zip(('qacc', 'f_simple', 'f_cone', 'qfrc'), got, ref, ref64):
        if not r64.numel() or not bool(same.any()):
            continue
        k64 = rel_err(g[same].double(), r64[same])
        e64 = rel_err(r[same].double(), r64[same])
        parts.append(f'{name} kernel {k64:.3e}, eager f32 {e64:.3e}')
        if not k64 <= max(ROUNDING_ERR_SLACK * e64, NEWTON_BAR):
            failures.append(f'Newton kernel {name} {k64} from f64, the eager f32 solve {e64}')
    log(phase, f'{label}: on the {int(same.sum())} envs where the kernel and both eager solves '
               f'stop at the same iteration, from eager f64: {"; ".join(parts)}; envs whose '
               f'count differs {n_k} (bar {count_bar:.0f}: f32 vs f64 {n_32})')
    if n_k > count_bar:
        failures.append(f'Newton iteration counts differ in {n_k} envs (bar {count_bar})')
    return failures


def spot_agreement(dm, phase=5):
    """Phase 5 on spot/flat. Returns (the max abs qacc difference of its
    soft per-env case, the bars failed)."""
    return newton_agreement(dm, phase, odd_all=True)[:2]


def go2_agreement(go2, phase=10, dims_needed=(3, 6)):
    """Phases 10 and 35: the fused Newton kernel against the eager solve on
    seeded soft go2 states: `three_solves` at the caps 10 and 30 (the kernel
    within GO2_CAP10_BAR of the eager f32 solve at 10), then phase 5 on go2
    at the cap of 30; the active blocks must include each cone dimension of
    `dims_needed`. Returns (the max abs qacc difference of phase 5's soft
    per-env case, the bars failed)."""
    M, a_s, efc = soft_state(go2, torch.Generator(device='cuda').manual_seed(SEED), BATCH)
    failures, _ = three_solves(go2, M, a_s, efc, f'{go2.m.robot}/{go2.m.scene} soft states',
                               phase, (10, GO2_AGREEMENT_ITERATIONS), GO2_CAP10_BAR)
    abs_err, more, dims = newton_agreement(go2, phase, GO2_AGREEMENT_ITERATIONS,
                                           GO2_ITERATION_ENVS_BAR)
    failures += more
    if not set(dims_needed) <= dims:
        failures.append(f'{go2.m.robot}/{go2.m.scene} soft states without active blocks of '
                        f'each condim of {dims_needed}: {dims}')
    return abs_err, failures


def log_start(dm, phase):
    """The start of a heightfield scene: how far the lift out of the terrain
    raised the keyframe, in how many rounds, and how far it was then lowered
    onto the terrain; the terrain's height under the base."""
    m = dm.m
    q, raised, lowered, rounds = start_qpos(dm)
    h = int(np.flatnonzero(m.geom_type == GEOM_HFIELD)[0])
    base = torch.as_tensor(m.key_qpos[0, :2] - m.geom_pos[h, :2], dtype=dm.dtype, device=dm.device)
    ground = collision.hfield_height(dm, base[0], base[1]).item() + float(m.geom_pos[h, 2])
    log(phase, f'{m.robot}/{m.scene} start: keyframe base z {m.key_qpos[0, 2]:.4f} over terrain '
               f'at height {ground:.4f}; the lift raised it {raised:.4f} m in {rounds} rounds, '
               f'then lowered {lowered:.4f} m onto the terrain: base z {q[2].item():.4f}')


def terrain_agreement(dm, phase):
    """Phase 35: `go2_agreement` on soft states against the terrain (the
    lifted keyframe, then U(0, 5) mm into it), after `log_start`: the feet
    touch the terrain alone, so the active blocks are the feet's condim-6
    ones."""
    log_start(dm, phase)
    return go2_agreement(dm, phase, dims_needed=(6,))


def pyramidal_agreement(dm, phase, presses=(0.0,), phase5=False):
    """Phases 15, 20 and 25: the fused Newton kernel against the eager solve
    on seeded states of a model with pyramidal contact rows, soft (the
    keyframe lowered by its clearance, then U(0, 5) mm into the floor) and
    pressed each further press of `presses` (aliengo's 3 cm: the body's
    boxes touch too and active pyramidal rows reach past row 64, the
    kernel's third ballot word): `three_solves` at the step's cap of 10 (the
    kernel within PYR_CAP10_BAR of the eager f32 solve). With `phase5`,
    then phase 5's checks with the last pressed states among its cases.
    Returns (the max abs qacc difference of phase 5's soft per-env case, or
    of the first `three_solves`, the bars failed)."""
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    failures, abs_err = [], None
    for press in presses:
        M, a_s, efc = soft_state(dm, gen, BATCH, press=press)
        rows = efc.active.nonzero()[:, 1]
        label = f'{dm.m.robot}/{dm.m.scene} ' + (f'states pressed {press * 100:g} cm' if press
                                                 else 'soft states')
        log(phase, f'{label}: active simple rows per env '
                   f'{efc.active.sum(1).float().mean().item():.3f}, the last active one row '
                   f'{int(rows.max())} of {efc.J.shape[1]}')
        more, err = three_solves(dm, M, a_s, efc, label, phase, (10,), PYR_CAP10_BAR)
        failures += more
        abs_err = err if abs_err is None else abs_err
        if press and not int(rows.max()) >= 64:
            failures.append(f'{label}: no active row past row 64')
    if phase5:
        abs_err, more, _ = newton_agreement(dm, phase, press=presses[-1])
        failures += more
    return abs_err, failures


@functools.cache
def smi():
    """The card's name and power limit, as nvidia-smi gives them (read once:
    the machine can set neither)."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip()


def card():
    """Phase 1: require the card, print its name and power limit, TF32 off."""
    if not torch.cuda.is_available():
        raise RuntimeError('chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False')
    print(smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(1, f'torch {torch.__version__} cuda {torch.version.cuda} '
           f'device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}; '
           f'matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} '
           f'cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}')


def activation(efc, C_all):
    """(B, ns + C_all) bool: which simple rows and which cone slots are
    active (a culled slot is inactive)."""
    cones = torch.zeros(efc.con_active.shape[0], C_all, dtype=torch.bool,
                        device=efc.con_active.device)
    return torch.cat([efc.active, cones.scatter_(1, efc.cone_sel, efc.con_active)], 1)


def active_contacts(efc, lay):
    """Active contact slots: cone blocks, plus pyramidal rows over the rows
    each slot has, or the first row of each unculled slot."""
    n = efc.con_active.sum()
    first, per_slot, _ = pyramidal_rows(lay)
    if len(lay.simple_con_slots) and not culled_pyramidal(lay):
        _, fric, sign = simple_slot_rows(lay)
        heads = torch.as_tensor((fric == 0) & (sign >= 0), device=efc.active.device)
        n = n + efc.active[:, first:][:, heads].sum()
    elif per_slot:
        n = n + efc.active[:, first:].sum() // per_slot
    return n


def main_path(dm, phase, steps, windows, n_cpu, start=None, on_step=None):
    """Phases 6, 11, 16, 21, 26, 36, 41 and 75-77: B=4096 f32 steps of
    `step_batched` from the start (`start_qpos`, or the (B, nq) `start`)
    with seeded U(-2, 2) torques and the qacc warm start; `on_step(fwd)`
    reads each step's Forward. Every
    launch count is set to 0 just before the run and read just after it.
    Checks: every state finite, contacts active, exactly 2 SPD and 1 Newton
    launch per step. Keeps, for the first n_cpu envs and each step of the
    CPU windows (CPU_STEPS from each start in `windows`), the step's input
    state and its constraint activation."""
    m = dm.m
    name = f'{m.robot}/{m.scene}'
    lay = constraint_layout(m)
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    ctrls = torch.rand(steps, BATCH, m.nu, generator=gen, device='cuda') * 4.0 - 2.0
    qpos = start_qpos(dm)[0].repeat(BATCH, 1) if start is None else start
    qvel = torch.zeros(BATCH, m.nv, device='cuda')
    warm = torch.zeros(BATCH, m.nv, device='cuda')
    finite = torch.ones((), dtype=torch.bool, device='cuda')
    n_active = torch.zeros((), dtype=torch.int64, device='cuda')
    C_all = len(lay.cone_slots)
    window = {t for t0 in windows for t in range(t0, t0 + CPU_STEPS + 1)}
    states, acts = {}, {}
    per_step = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spd.launches = 0
    nf.launches = 0
    t0 = time.perf_counter()
    for t in range(steps):
        if t in window:
            states[t] = (qpos[:n_cpu].clone(), qvel[:n_cpu].clone(), warm[:n_cpu].clone())
        before = spd.launches, nf.launches
        warm_in = warm
        qpos, qvel, fwd = engine.step_batched(dm, qpos, qvel, ctrls[t], warmstart=warm)
        warm = fwd.qacc
        if on_step is not None:
            on_step(fwd)
        if t in window:
            acts[t] = activation(fwd.efc, C_all)[:n_cpu]
        per_step.append((spd.launches - before[0], nf.launches - before[1]))
        finite &= torch.isfinite(qpos).all() & torch.isfinite(qvel).all()
        n_active += active_contacts(fwd.efc, lay)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if steps in window:
        states[steps] = (qpos[:n_cpu].clone(), qvel[:n_cpu].clone(), warm[:n_cpu].clone())
    launches = {'spd_solve': spd.launches, 'newton_fused': nf.launches}
    efc = fwd.efc
    log(phase, f'{name} B={BATCH} f32: {steps} steps in {wall:.3f} s = {steps / wall:.2f} '
               f'steps/s = {BATCH * steps / wall:.1f} env-steps/s on {smi()}')
    log(phase, f'launches: spd_solve {launches["spd_solve"]}, newton_fused '
               f'{launches["newton_fused"]} (per step {sorted(set(per_step))}); active contact '
               f'slots summed over steps {int(n_active)}; final mean base height '
               f'{qpos[:, 2].mean().item():.4f}')
    per_env = lambda mask: mask.sum(1).float().mean().item()
    first, _, _ = pyramidal_rows(lay)
    log(phase, f'last step: ns={efc.J.shape[1]}, C={efc.con_J.shape[1]} of {C_all} cone '
               f'slots; active simple rows per env {per_env(efc.active):.3f} (of which contact '
               f'rows {per_env(efc.active[:, first:]):.3f}), active cone blocks '
               f'per env {per_env(efc.con_active):.3f}; peak device memory '
               f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB on {smi()}')
    if not bool(finite):
        raise AssertionError(f'a state of the {name} path is not finite')
    if int(n_active) == 0:
        raise AssertionError(f'no contact became active on {name}: the contact path was '
                             f'not exercised')
    if any(k != (2, 1) for k in per_step):
        raise AssertionError(f'expected 2 spd_solve and 1 newton_fused launch per step on '
                             f'{name}, got {sorted(set(per_step))}')
    return {'ctrls': ctrls, 'states': states, 'acts': acts, 'launches': launches,
            'last': (fwd.M, fwd.qacc_smooth, efc, warm_in),   # the last step's Newton inputs
            'state': (qpos, qvel, warm), 'windows': windows, 'n_cpu': n_cpu,
            'steps_per_s': steps / wall}


def card_continued(dm, start, t0, n):
    """A window past the main path's last step: the card steps its first n
    envs on from the state `start` at step t0, CPU_STEPS times, with seeded
    U(-2, 2) torques. Returns (torques, activations, final qpos)."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + t0)
    ctrls = torch.rand(CPU_STEPS, n, dm.m.nu, generator=gen, device='cuda') * 4.0 - 2.0
    C_all = len(constraint_layout(dm.m).cone_slots)
    q, v, w = start
    acts = []
    for t in range(CPU_STEPS):
        q, v, f = engine.step_batched(dm, q, v, ctrls[t], warmstart=w)
        w = f.qacc
        acts.append(activation(f.efc, C_all))
    return ctrls, acts, q


def card_against_cpu(dm, run, phase, cap=None, cpu_spec=None, then=None):
    """Phases 7, 12, 17, 22, 27, 37 and 79: the run's first envs stepped
    CPU_STEPS times in f64 on the CPU through the same functions, from the
    card's states at each start of the run's windows; every env's qpos after
    the steps within 1e-3 of the card's f32 state. A window that ends past
    the main path's last step (hyqreal2/random_boxes', whose feet land
    after ~18 steps) continues those envs on the card (`card_continued`).
    With a Newton `cap` (phases 53, 58 and 63: 30, where the cap of 10
    leaves f32 solves unconverged), the card steps the window's envs again
    at that cap from the same state and both sides run at it; the main
    path's own state at the cap of 10 is printed beside it.
    The line also counts the envs whose set of active simple rows and cone
    slots differed from the card's at some step (a row at its activation
    threshold to rounding), which would explain a failure. `cpu_spec`
    names the CPU's f64 model for `cpu_model` (by default dm's robot and
    scene). The f64 steps run in a CPU worker (`later`): each window's line
    and check come when it is done, and then `then(errs)`, each window's
    max |qpos diff|."""
    torch.set_num_threads(1)   # tiny batched products: one thread is fastest
    m = dm.m
    spec = cpu_spec or (m.robot, m.scene)
    errs = []
    C_all = len(constraint_layout(m).cone_slots)
    ctrls, states, acts, n = run['ctrls'], run['states'], run['acts'], run['n_cpu']
    windows = run['windows']
    for t0 in windows:
        if t0 + CPU_STEPS > ctrls.shape[0]:
            ctrl_w, acts_w, end = card_continued(dm, states[t0], t0, n)
        else:
            ctrl_w = ctrls[t0:t0 + CPU_STEPS, :n]
            acts_w = [acts[t] for t in range(t0, t0 + CPU_STEPS)]
            end = states[t0 + CPU_STEPS][0]
        at_cap10 = end
        if cap is not None:
            qc, vc, wc = states[t0]
            acts_w = []
            for ctrl in ctrl_w:
                qc, vc, fc = engine.step_batched(dm, qc, vc, ctrl, warmstart=wc,
                                                 solver_iterations=cap)
                wc = fc.qacc
                acts_w.append(activation(fc.efc, C_all))
            end = qc

        def finish(result, t0=t0, end=end.double().cpu(), at_cap10=at_cap10.double().cpu()):
            q, switched = result
            err = (end - q).abs().max().item()
            errs.append(err)
            beside = '' if cap is None else (
                f' (both at a Newton cap of {cap}; the main path at the cap of 10 against it '
                f'{(at_cap10 - q).abs().max().item():.3e})')
            log(phase, f'{m.robot}/{m.scene}, {n} envs, steps {t0}..{t0 + CPU_STEPS}: card f32 '
                       f'vs CPU f64 max |qpos diff| {err:.3e}{beside}; envs where a row or slot '
                       f'switched on one side only {int(switched.sum())}', late=True)
            # f32 steps against f64 steps: the f32 Newton tolerance is 1e-6 of
            # |qacc| and 20 steps of 2 ms keep the drift far below the 1e-3 qpos
            # bar that the reference holds against MuJoCo
            if not err < 1e-3:
                raise AssertionError(f'{m.robot}/{m.scene}: card and CPU trajectories differ by '
                                     f'{err}')
            if then is not None and len(errs) == len(windows):
                then(errs)

        start = tuple(x.double().cpu() for x in states[t0])
        later(cpu_window, (spec, start, ctrl_w.double().cpu(), [a.cpu() for a in acts_w], cap),
              finish)


def newton_timing(last, phase, rounding=False, cap=10):
    """Phases 8, 13, 18, 23 and 28: Newton timings on a main path's last
    step inputs, in both forms: the fused kernel (through its C entry
    point, as in phase 4, and through the wrapper), the eager `solver.solve`
    on the card and two bounds from the iterations the kernel ran (dense;
    what these inputs need, the one the kernels line reports). The kernel
    is held to the eager f32 solve within NEWTON_BAR on the envs both
    converged at the step's cap of 10 (an env stopped at the cap is not
    converged, and there the two f32 solves may end far apart: go2's);
    with `rounding` (ROUNDING_ROBOTS), as `rounding_bars` does: on those
    envs the kernel within ROUNDING_ERR_SLACK x the eager f32 solve's
    distance from an eager f64 solve, or NEWTON_BAR. `cap` replaces the
    step's cap of 10 where the inputs are one env's (phase 74: go2's f32
    solve may stop unconverged at 10, so it runs at go2's cap of 30)."""
    M, a_s, efc, w = last
    B, nv = a_s.shape
    ns, C = efc.J.shape[1], efc.con_J.shape[1]
    it = torch.zeros(B, dtype=torch.int32, device='cuda')
    outs = nf.solve_batched(M, a_s, efc, warmstart=w, iterations=cap, iterations_out=it)
    newton_c = nf._library(nv).gqt_newton_fused_f32
    outputs = tuple(torch.empty_like(x) for x in outs)
    tol = solver._TOL[torch.float32]
    args = nf.kernel_args(M, a_s, efc, w, outputs, None, cap, LS_ITERATIONS, tol)
    args_bt = nf.kernel_args(M, a_s, efc, w, outputs, None, 10, LS_ITERATIONS, 0.0)
    it_ref = torch.zeros_like(it)
    ref = solver.solve(M, a_s, efc, warmstart=w, iterations=cap, iterations_out=it_ref)
    done = (it < cap) & (it_ref < cap)
    n_done = int(done.sum())
    err_done = rel_err(outs[0][done], ref[0][done]) if n_done else float('nan')
    # which of the two f32 solves is nearer the solution: an eager f64 solve
    # at its own tolerance (1e-10) with a cap of 30, its SPD solves plain
    it_64 = torch.zeros_like(it)
    with mock.patch.object(solver, 'spd_solve_batched', spd.unrolled_chol_solve_torch):
        ref64 = solver.solve(M.double(), a_s.double(), as_f64(efc), w.double(), 30,
                             iterations_out=it_64)[0]
    done64 = done & (it_64 < 30)
    kernel_f64 = rel_err(outs[0][done64], ref64[done64]) if bool(done64.any()) else float('nan')
    eager_f64 = rel_err(ref[0][done64], ref64[done64]) if bool(done64.any()) else float('nan')
    rows = efc.active.nonzero()[:, 1]
    newton_ms = median_ms(lambda: newton_c(*args))
    newton_bt_ms = median_ms(lambda: newton_c(*args_bt))
    newton_wrapper_ms = median_ms(lambda: nf.solve_batched(M, a_s, efc, warmstart=w,
                                                           iterations=cap))
    # the eager solve takes 50-180 ms: one warm-up call is enough
    eager_ms = median_ms(lambda: solver.solve(M, a_s, efc, warmstart=w, iterations=cap),
                         launches=3, repeats=3, warmup=1)
    inputs = [M, a_s, w] + [getattr(efc, k) for k in nf.EFC_FLOAT_FIELDS + nf.EFC_MASK_FIELDS]
    n_bytes = sum(x.numel() * x.element_size() for x in inputs + list(outs))
    env_iterations = int(it.sum())
    n_flop = newton_flop(nv, ns, C, env_iterations, B)
    dense_bound_ms, dense_bound_by = bound(n_bytes, n_flop)
    act_flop, act_bytes = newton_needed_work(M, efc, it)
    newton_bound_ms, newton_bound_by = bound(act_bytes, act_flop)
    blocks, per_block, smem = nf.occupancy(nv, ns, C)
    log(phase, f'(B={B}, nv={nv}, ns={ns}, C={C}), the last main-path step: fused kernel '
               f'{newton_ms:.4f} ms (through the wrapper {newton_wrapper_ms:.4f} ms), eager '
               f'solver.solve {eager_ms:.4f} ms; {env_iterations} '
               f'env-iterations, mean {env_iterations / B:.3f}, max {int(it.max())}; active '
               f'simple rows per env {efc.active.sum(1).float().mean().item():.3f}, active cone '
               f'blocks {efc.con_active.sum(1).float().mean().item():.3f}; residency {blocks} '
               f'blocks of {per_block} envs per SM, {smem} B of shared memory per block; no '
               f'single PyTorch call computes a Newton contact solve; the last active simple '
               f'row {int(rows.max()) if rows.numel() else None}; qacc kernel vs eager f32 on '
               f'the {n_done} envs both converged {err_done:.3e}, on every env '
               f'{rel_err(outs[0], ref[0]):.3e} (of 1 + max|qacc|), envs whose iteration count '
               f'differs {int((it != it_ref).sum())}; on {smi()}')
    log(phase, f'the same {n_done} envs against an eager f64 solve (cap 30, tolerance 1e-10; '
               f'{int(done64.sum())} of them converged in f64): kernel {kernel_f64:.3e}, eager '
               f'f32 {eager_f64:.3e} of 1 + max|qacc|: the '
               f'{"kernel" if kernel_f64 < eager_f64 else "eager f32 solve"} is nearer f64')
    if rounding:
        if not kernel_f64 <= max(ROUNDING_ERR_SLACK * eager_f64, NEWTON_BAR):
            raise AssertionError(f'Newton kernel {kernel_f64} from f64 on the last main-path '
                                 f'step, the eager f32 solve {eager_f64}')
    elif not err_done < NEWTON_BAR:
        raise AssertionError(f'Newton kernel off by {err_done} from the eager solve on the '
                             f'{n_done} envs of the last main-path step both converged')
    log(phase, f'bound of what these inputs need (reported): {newton_bound_ms:.5f} ms '
               f'({newton_bound_by}: {act_bytes / 1e6:.2f} MB, {act_flop / 1e9:.3f} GFLOP) = '
               f'{newton_ms / newton_bound_ms:.1f}x; dense bound: {dense_bound_ms:.5f} ms '
               f'({dense_bound_by}: {n_bytes / 1e6:.2f} MB, {n_flop / 1e9:.3f} GFLOP) = '
               f'{newton_ms / dense_bound_ms:.1f}x')
    # the fixed-count form on the same inputs: every env runs 10 iterations
    eager_bt_ms = median_ms(lambda: solver.solve(M, a_s, efc, warmstart=w, _tol=0.0),
                            launches=3, repeats=3, warmup=1)
    bt_flop = newton_flop(nv, ns, C, 10 * B, B)
    bt_bound_ms, bt_bound_by = bound(n_bytes, bt_flop)
    bt_act_flop, _ = newton_needed_work(M, efc, torch.full_like(it, 10))
    bt_act_ms, bt_act_by = bound(act_bytes, bt_act_flop)
    log(phase, f'fixed 10 iterations: fused kernel {newton_bt_ms:.4f} ms, eager solver.solve '
               f'{eager_bt_ms:.4f} ms, bound of what these inputs need {bt_act_ms:.5f} ms '
               f'({bt_act_by}: {bt_act_flop / 1e9:.3f} GFLOP) = {newton_bt_ms / bt_act_ms:.1f}x, '
               f'dense bound {bt_bound_ms:.5f} ms ({bt_bound_by}: {bt_flop / 1e9:.3f} GFLOP)')
    return {'ms': newton_ms, 'plain_ms': eager_ms, 'bound_ms': newton_bound_ms,
            'bound_by': newton_bound_by, 'last_step_rel_err': err_done,
            'last_step_kernel_vs_f64': kernel_f64, 'last_step_eager_vs_f64': eager_f64}


def device_profile(dm, run, phase, n_steps=2):
    """Phases 9, 14, 19, 24 and 29: a device profile of a few steps: busy share, kernel
    launches per step, host and device time of the step's stages and of the
    port's two kernels, top kernels."""
    from torch.profiler import ProfilerActivity, profile
    qpos, qvel, warm = run['state']
    ctrls = run['ctrls']
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for t in range(n_steps):
            qpos, qvel, fwd = engine.step_batched(dm, qpos, qvel, ctrls[t], warmstart=warm)
            warm = fwd.qacc
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    # the stage ranges appear twice: as host ranges (their device time is the
    # kernels they launched) and as device-side annotations, kept out of the
    # kernel sums
    stages = ('smooth', 'contacts', 'narrow_phase', 'assembly', 'newton', 'euler')
    cuda = torch.autograd.DeviceType.CUDA
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == cuda and e.key not in stages]
    dev_us = sum(e.self_device_time_total for e in kernels)
    if dev_us <= 0:
        log(phase, 'the profiler recorded no device time: busy share not measured')
        return
    n_kernels = sum(e.count for e in kernels)
    log(phase, f'{dm.m.robot}/{dm.m.scene}, {n_steps} steps: wall {prof_wall * 1e3:.1f} ms '
               f'(profiled), device busy {dev_us / 1e3:.1f} ms = '
               f'{dev_us / 1e4 / prof_wall:.1f}%; kernel launches {n_kernels} = '
               f'{n_kernels / n_steps:.1f} per step; on {smi()}')
    for e in averages:
        if e.key in stages and e.device_type != cuda:
            log(phase, f'  stage {e.key:12s} host {e.cpu_time_total / 1e3:8.2f} ms, '
                       f'device {e.device_time_total / 1e3:8.3f} ms')
    # the profiler gives a stage only the kernels that PyTorch launched in
    # it: the port's own kernels, launched through ctypes, are added here
    for name, stage in (('newton_kernel', 'newton'), ('spd_solve_kernel', 'smooth, euler')):
        own = [e for e in kernels if name in e.key]
        log(phase, f'  {name} (stage {stage}): device '
                   f'{sum(e.self_device_time_total for e in own) / 1e3:8.3f} ms, '
                   f'{sum(e.count for e in own)} launches')
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(phase, f'  {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x  {e.key[:90]}')


class OpCount(TorchDispatchMode):
    """Counts the tensor operations dispatched inside it, views left out
    (an operation whose results only alias its inputs launches nothing)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        returns = func._schema.returns
        if not (returns and all(r.alias_info is not None and not r.alias_info.is_write
                                for r in returns)):
            self.count += 1
        return func(*args, **(kwargs or {}))


def narrow_phase_groups(dm, run, phase):
    """Phases 9, 14, 19, 24 and 29: each pair group of the narrow phase on the
    last main-path state (the card's name and power limit on the first
    line): ms on the stream (CUDA events around 3 calls, so it includes time
    the card waits for launches: near the host time, the group is
    host-bound), host ms to enqueue, and the tensor operations it
    dispatches, views left out (each launches one kernel or a few); a group
    slower than 0.2 s is timed over the one call that counts its operations
    (the count's dispatch mode adds to its host time, not much to its
    stream time). Returns {group: stream ms}."""
    stream = {}
    kin = kinematics.fk(dm, run['state'][0])
    log(phase, f'narrow phase of {dm.m.robot}/{dm.m.scene} by pair group, on {smi()}:')
    with OpCount():     # the dispatch mode's first use in a process takes seconds
        torch.zeros(1, device='cuda').add_(1)
    torch.cuda.synchronize()
    for args in collision.group_args(dm, kin):   # collide's own gather
        t1, t2 = args[1]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        with OpCount() as ops:
            collision._group(*args)
        end.record()
        torch.cuda.synchronize()
        n = 1
        if time.perf_counter() - h0 < 0.2:     # a fast group: 3 calls without the count
            n = 3
            h0 = time.perf_counter()
            start.record()
            for _ in range(n):
                collision._group(*args)
            end.record()
        host_ms = (time.perf_counter() - h0) / n * 1e3
        torch.cuda.synchronize()
        group = f'{collision._GEOM_NAMES[t1]}-{collision._GEOM_NAMES[t2]}'
        stream[group] = start.elapsed_time(end) / n
        log(phase, f'  narrow phase {group} ({args[2].shape[1]} pairs): stream '
                   f'{stream[group]:.3f} ms, host {host_ms:.3f} ms, {ops.count} tensor '
                   f'operations')
    return stream


def sync_count(fn):
    """The host synchronisations that CUDA's sync debug mode reports in a
    second call of `fn()`, after one to warm up (kernels launched through
    ctypes are not seen), and the first message."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('warn')
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            fn()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    syncs = [str(w.message) for w in caught if 'synchroniz' in str(w.message)]
    return len(syncs), (syncs[0][:200] if syncs else None)


def host_ms(fn, repeats=3):
    """Median host ms of `fn()` followed by a synchronise."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def all_finite(state, obs):
    """A device bool: every float of the state (its sensor states too) and
    the observations finite. The IMU's readings start as NaN until its first
    reading, which `reset` takes."""
    ok = torch.ones((), dtype=torch.bool, device=state.qpos.device)
    tensors = [getattr(state, f.name) for f in tensor_fields(state)] + list(obs.values())
    tensors += [getattr(ss, f.name) for ss in state.sensors for f in dataclasses.fields(ss)]
    for x in tensors:
        if x.is_floating_point():
            ok = ok & torch.isfinite(x).all()
    return ok


def env_main_path(bare_steps_per_s, phase=30, scene='flat', command='forward', steps=STEPS,
                  bare_phase=11, robot='go2', B=BATCH):
    """Phases 30, 40 and 66: the env layer's main path, `robot` (go2) on
    `scene` at B (4096) in f32 through `QuadrupedEnv(...).reset` and `.step`, per-env friction
    and a `command` velocity command: a random reset, then `steps` steps
    with seeded U(-2, 2) torques and the default observables, the launch
    counts set to 0 just before the steps and read just after (exactly 2 SPD
    and 1 Newton launch per step), every state and observable finite,
    env-steps/s beside the bare step's of `bare_phase` in this call, peak
    device memory, host synchronisations of one env.step against one
    step_batched. Keeps the first N_CPU_ENVS envs' state at step 100 and
    after CPU_STEPS more, for phase 32."""
    env = QuadrupedEnv(robot, scene=scene, base_vel_command_type=command,
                       ref_base_lin_vel=(0.0, 1.0), ground_friction_coeff=(0.5, 1.5))
    dm = env.model
    name = f'{robot}/{scene}'

    gen = torch.Generator(device='cuda').manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spd.launches = nf.launches = 0
    t0 = time.perf_counter()
    state, obs = env.reset(gen, B)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    mu = state.geom_friction[:, dm.m.feet_geom_id[0], 0]
    log(phase, f'{name} env reset B={B}: {reset_s:.3f} s, {env.lift_rounds} rounds of the '
               f'lift out of contact, launches spd_solve {spd.launches}, newton_fused '
               f'{nf.launches}; feet friction per env in [{mu.min().item():.3f}, '
               f'{mu.max().item():.3f}]; on {smi()}')
    actions = torch.rand(steps, B, dm.m.nu, generator=gen, device='cuda') * 4.0 - 2.0
    finite = all_finite(state, obs)
    kept = {}
    per_step = []
    torch.cuda.synchronize()
    spd.launches = nf.launches = 0
    t0 = time.perf_counter()
    for t in range(steps):
        if t in (100, 100 + CPU_STEPS):
            kept[t] = state.map(lambda x: x[:N_CPU_ENVS].clone())
        before = spd.launches, nf.launches
        state, obs, reward, term, trunc, info = env.step(state, actions[t])
        per_step.append((spd.launches - before[0], nf.launches - before[1]))
        finite &= all_finite(state, obs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {'spd_solve': spd.launches, 'newton_fused': nf.launches}
    rate = steps / wall
    log(phase, f'{name} env.step B={B} f32: {steps} steps in {wall:.3f} s = {rate:.2f} '
               f'steps/s = {B * rate:.1f} env-steps/s; the bare step_batched of phase {bare_phase} '
               f'in this call {bare_steps_per_s:.2f} steps/s = {B * bare_steps_per_s:.1f} '
               f'env-steps/s (env/bare {rate / bare_steps_per_s:.3f}); peak device memory from '
               f'the reset on {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; on {smi()}')
    log(phase, f'launches: spd_solve {launches["spd_solve"]}, newton_fused '
               f'{launches["newton_fused"]} (per step {sorted(set(per_step))}); terminated at the '
               f'last step {int(term.sum())} of {B}; mean base height '
               f'{state.qpos[:, 2].mean().item():.4f}')
    if not bool(finite):
        raise AssertionError(f'a state or observation of the {name} env path is not finite')
    if any(k != (2, 1) for k in per_step):
        raise AssertionError(f'expected 2 spd_solve and 1 newton_fused launch per env.step, got '
                             f'{sorted(set(per_step))}')
    action = actions[-1]
    ctrl_syncs = sync_count(lambda: engine.step_batched(dm, state.qpos, state.qvel, action,
                                                        warmstart=state.qacc))
    env_syncs = sync_count(lambda: env.step(state, action))
    log(phase, f'host synchronisations reported per call: env.step {env_syncs[0]}, its '
               f'step_batched alone {ctrl_syncs[0]} (first: {env_syncs[1] or ctrl_syncs[1]})')
    if env_syncs[0] != ctrl_syncs[0]:
        raise AssertionError(f'env.step syncs {env_syncs} times, its step_batched {ctrl_syncs}')
    return {'env': env, 'gen': gen, 'state': state, 'actions': actions, 'kept': kept,
            'launches': launches}


def env_all_obs(run, phase=31):
    """Phase 31: CPU_STEPS steps of the go2/flat env with all 31 observables:
    each finite and of its obs_dim; the share of feet in contact, the culled
    contacts; host and device ms of the observables alone (the default five
    and all 31) on one Forward."""
    env = run['env']
    dm = env.model
    env31 = QuadrupedEnv('go2', state_obs_names=ALL_OBS, base_vel_command_type='forward',
                         ref_base_lin_vel=(0.0, 1.0), ground_friction_coeff=(0.5, 1.5),
                         model=dm)
    state = run['state']
    dims = env31.observation_space_dims()
    ok = torch.ones((), dtype=torch.bool, device='cuda')
    touch, culled = [], []
    for t in range(CPU_STEPS):
        state, obs, reward, term, trunc, info = env31.step(state, run['actions'][t])
        for name, v in obs.items():
            if v.shape != (BATCH, dims[name]):
                raise AssertionError(f'observable {name}: shape {tuple(v.shape)}, '
                                     f'expected {(BATCH, dims[name])}')
            ok &= torch.isfinite(v).all()
        touch.append(obs['contact_state'])
        culled.append(info['culled_contacts'])
    if not bool(ok):
        raise AssertionError('an observable of the go2/flat env is not finite')
    culled = torch.stack(culled)
    log(phase, f'go2/flat, all {len(ALL_OBS)} observables over {CPU_STEPS} steps: finite, each '
               f'of its obs_dim; feet in contact {torch.stack(touch).mean().item():.4f} of the '
               f'feet; culled contacts (touching cone slots past the cap of 32) '
               f'{int(culled.sum())} in all, at most {int(culled.max())} in an env and step')
    _, _, fwd = engine.step_batched(dm, state.qpos, state.qvel, run['actions'][0],
                                    warmstart=state.qacc)
    for names in (env.state_obs_names, ALL_OBS):
        call = lambda: obslib.compute_obs(dm, names, state.qpos, state.qvel, state.ctrl, fwd,
                                          state.ref_base_lin_vel_H, state.ref_base_ang_yaw_dot)
        call()
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        call()
        enqueue = (time.perf_counter() - h0) * 1e3
        log(phase, f'observables ({len(names)}): device {median_ms(call, launches=5, repeats=3):.3f} '
                   f'ms per call on the stream, host {enqueue:.3f} ms to enqueue; on {smi()}')


def env_card_against_cpu(run, phase=32, cap=GO2_AGREEMENT_ITERATIONS):
    """Phase 32: card against CPU. The first N_CPU_ENVS envs of the card's
    state at step 100, moved along the floor to x = y = 0 (the flat floor is
    the same everywhere), stepped CPU_STEPS times through env.step on the
    card (f32) and on the CPU (f64) with the main path's actions and a
    Newton cap of `cap`: every env's qpos within 1e-3. Two readings beside
    it, at the step's cap of 10: from the same moved states, where an f32
    solve stopped unconverged at the cap (phase 10) carries its error on;
    and the main path's own states at their spawn positions, up to 10 km
    out (the flat scene's terrain limits), where f32 resolves a position to
    0.5-1 mm."""
    torch.set_num_threads(1)
    env, actions = run['env'], run['actions']
    cfg = dict(base_vel_command_type='forward', ref_base_lin_vel=(0.0, 1.0),
               ground_friction_coeff=(0.5, 1.5))
    start = run['kept'][100]
    centred = start.map(torch.clone)
    centred.qpos[:, :2] = 0.0
    acts = actions[100:100 + CPU_STEPS, :N_CPU_ENVS]
    card = {}
    for it in (cap, 10):
        s = centred
        step = QuadrupedEnv('go2', model=env.model, solver_iterations=it, **cfg).step
        for a in acts:
            s = step(s, a)[0]
        card[it, 'origin'] = s.qpos.double().cpu()
    card[10, 'spawn'] = run['kept'][100 + CPU_STEPS].qpos.double().cpu()   # the main path's own
    dist = start.qpos[:, :2].abs().amax(-1)

    def finish(cpu):
        def err(it, where):
            per_env = (card[it, where] - cpu[it, where]).abs().amax(-1)
            return per_env.max().item(), int((per_env >= 1e-3).sum())

        gate, at10, spawn = err(cap, 'origin'), err(10, 'origin'), err(10, 'spawn')
        log(phase, f'go2/flat env, {N_CPU_ENVS} envs, steps 100..{100 + CPU_STEPS}, card f32 vs '
                   f'CPU f64 max |qpos diff| (envs at 1e-3 or more): moved to the origin, Newton '
                   f'cap {cap} {gate[0]:.3e} ({gate[1]}); the same at the cap of 10 '
                   f'{at10[0]:.3e} ({at10[1]}); the main path\'s own states at their spawn '
                   f'positions (|x|, |y| up to {dist.max().item():.1f} m, the nearest '
                   f'{dist.min().item():.1f} m), cap 10 {spawn[0]:.3e} ({spawn[1]})', late=True)
        if not gate[0] < 1e-3:
            raise AssertionError(f'go2/flat env: card and CPU trajectories differ by {gate[0]}')

    # the CPU's f64 runs in the workers: (cap, where)
    cpu_runs = ((cap, 'origin'), (10, 'origin'), (10, 'spawn'))
    later_all([(cpu_env_steps, ('go2', 'flat', dict(cfg, solver_iterations=it),
                                (centred if where == 'origin' else start).to('cpu', torch.float64),
                                acts.double().cpu())) for it, where in cpu_runs],
              lambda results: finish({k: r[0].qpos for k, r in zip(cpu_runs, results)}))


def env_quarantine(run, phase=33):
    """Phase 33: NaN in qvel of a few envs, one quarantine_step: exactly
    those reset (step 0), marked terminated and counted, the others as a
    plain env.step; its time against a plain env.step, healthy and not."""
    env, gen, state, action = run['env'], run['gen'], run['state'], run['actions'][0]
    poisoned = [5, BATCH // 4, BATCH - 1]
    qvel = state.qvel.clone()
    qvel[poisoned, 4] = float('nan')
    bad = dataclasses.replace(state, qvel=qvel)
    out = quarantine_step(env, bad, action, gen)
    plain = env.step(bad, action)
    reset = (out[0].step_num == 0).nonzero()[:, 0].tolist()
    term = out[3]
    healthy = torch.ones(BATCH, dtype=torch.bool, device='cuda')
    healthy[poisoned] = False
    diff = (out[0].qpos[healthy] - plain[0].qpos[healthy]).abs().max().item()
    log(phase, f'go2/flat quarantine of envs {poisoned}: reset {reset}, quarantined '
               f'{int(out[5]["quarantined"])}, terminated {bool(term[poisoned].all())}, '
               f'every state finite {not bool(bad_state_mask(out[0]).any())}; the other envs '
               f'against a plain env.step: max |qpos diff| {diff:.3e}')
    if reset != poisoned or int(out[5]['quarantined']) != len(poisoned) \
            or not bool(term[poisoned].all()) or bool(bad_state_mask(out[0]).any()) \
            or not diff < 1e-6:
        raise AssertionError('quarantine_step did not reset exactly the poisoned envs')
    t_bad = host_ms(lambda: quarantine_step(env, bad, action, gen))
    t_ok = host_ms(lambda: quarantine_step(env, state, action, gen))
    t_plain = host_ms(lambda: env.step(state, action))
    log(phase, f'host ms per call (synchronised, median of 3): quarantine_step with 3 poisoned '
               f'envs {t_bad:.1f}, healthy {t_ok:.1f}, plain env.step {t_plain:.1f}; on {smi()}')


# the lifts out of contact at reset that phase 34 computed, for phase 44: an
# env of the same robot and scene reset from the same seed draws the same
# random pose, and the lift is deterministic (hyqreal2/random_boxes' runs
# its cap of 100 rounds, ~20 s)
LIFTS = {}


def memo_lift(env, key):
    """Serve env's reset lift from LIFTS[key] where its input equals the kept
    one (then `env.lift_served` is True), else compute it and keep it."""
    lift = env._lift_until_no_contact
    env.lift_served = False

    def memo(qpos):
        if key in LIFTS and torch.equal(LIFTS[key][0], qpos):
            env.lift_served = True
            out, rounds = LIFTS[key][1]
            return out.clone(), rounds
        out = lift(qpos)
        LIFTS[key] = (qpos.clone(), (out[0].clone(), out[1]))
        return out

    env._lift_until_no_contact = memo


def env_random_boxes(phase=34, steps=5):
    """Phase 34: the hyqreal2/random_boxes env (BASELINE cfg4) at B=4096 with a
    forward+rotate command: random reset (lift rounds), `steps` steps with
    seeded U(-2, 2) torques, env-steps/s, launches, peak memory, finite."""
    env = QuadrupedEnv('hyqreal2', scene='random_boxes', base_vel_command_type='forward+rotate',
                       ref_base_lin_vel=(0.0, 1.0), ref_base_ang_vel=(-0.5, 0.5))
    memo_lift(env, ('hyqreal2', 'random_boxes'))
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, obs = env.reset(gen, BATCH)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    actions = torch.rand(steps, BATCH, env.model.m.nu, generator=gen, device='cuda') * 4 - 2
    finite = all_finite(state, obs)
    spd.launches = nf.launches = 0
    t0 = time.perf_counter()
    for t in range(steps):
        state, obs, reward, term, trunc, info = env.step(state, actions[t])
        finite &= all_finite(state, obs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(phase, f'hyqreal2/random_boxes env B={BATCH}: reset {reset_s:.3f} s ({env.lift_rounds} '
               f'lift rounds); {steps} env.steps in {wall:.3f} s = {steps / wall:.3f} steps/s = '
               f'{BATCH * steps / wall:.1f} env-steps/s; launches spd_solve {spd.launches}, '
               f'newton_fused {nf.launches}; yaw command in [{state.ref_base_ang_yaw_dot.min().item():.3f}, '
               f'{state.ref_base_ang_yaw_dot.max().item():.3f}]; terminated at the last step '
               f'{int(term.sum())}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} '
               f'GiB; on {smi()}')
    if not bool(finite):
        raise AssertionError('a state or observation of the hyqreal2/random_boxes env is not finite')
    if (spd.launches, nf.launches) != (2 * steps, steps):
        raise AssertionError(f'hyqreal2/random_boxes env: launches {spd.launches}, {nf.launches}')


def terrain_steps(phase=41, steps=5):
    """Phase 41: b2/perlin (the heightfield-cylinder group) and
    hyqreal2/perlin (72 prisms per heightfield-box pair) at B=4096, `steps`
    steps of `step_batched` each from the start on the terrain (phase 36's
    checks: finite, contacts, 2 SPD and 1 Newton launch per step; steps/s,
    peak memory), then each narrow-phase group's stream and host ms.
    Returns {robot: launches}."""
    out = {}
    for robot in ('b2', 'hyqreal2'):
        dm = load_model(robot, 'perlin', device='cuda', dtype=torch.float32)
        log_start(dm, phase)
        run = main_path(dm, phase, steps, (), 0)
        narrow_phase_groups(dm, run, phase)
        out[robot] = run['launches']
        del run
    return out


# The main paths, five phases each (Newton agreement, main path, card against
# CPU, Newton timing, profile) from `phase`: robot, scene, steps on the card,
# the steps the CPU comparison starts from, the envs it steps, the agreement
# phase, the prefix of the kernels line's fields. spot and go2/flat run 100
# steps, aliengo and b2 41, go2/perlin 21 (cut for the run's clock: the
# whole script must stay well under 1,200 s on a slow host). aliengo's and
# b2's feet start above the floor and touch it after ~25 and ~30 steps:
# their comparison covers steps 40-60, the card stepping its envs on past
# the main path. hyqreal2/random_boxes' feet touch from step
# ~18: its comparison covers steps 20-40, the card stepping its 4 envs on
# past the main path's 20. go2/perlin (BASELINE cfg2) starts on the terrain
# (`start_qpos`).
SCENES = (
    (5, 'spot', 'flat', 100, (0, 80), N_CPU_ENVS, spot_agreement, ''),
    (10, 'go2', 'flat', 100, (0,), N_CPU_ENVS, go2_agreement, 'go2_'),
    (15, 'aliengo', 'flat', 41, (40,), N_CPU_ENVS,
     lambda dm, phase: pyramidal_agreement(dm, phase, (0.0, PRESS), phase5=True), 'aliengo_'),
    (20, 'b2', 'flat', 41, (40,), N_CPU_ENVS, pyramidal_agreement, 'b2_'),
    (25, 'hyqreal2', 'random_boxes', 20, (20,), 4, pyramidal_agreement, 'hyqreal2_'),
    (35, 'go2', 'perlin', 21, (0,), N_CPU_ENVS, terrain_agreement, 'go2_perlin_'),
)


def scene_phases(entry, spd_fields, newton_fields, cpu_cap=None, profile_steps=1):
    """One SCENES entry's five phases; fills its kernels-line fields and
    returns its main path's steps/s. `cpu_cap` as `card_against_cpu`'s;
    the profile covers `profile_steps` steps."""
    phase, robot, scene, steps, windows, n_cpu, agreement, prefix = entry
    dm = load_model(robot, scene, device='cuda', dtype=torch.float32)
    sizes = newton_sizes(dm.m)
    blocks, per_block, smem = nf.occupancy(*sizes)
    log(phase, f'newton_fused at {robot}/{scene} (nv, ns, C)={sizes}: {blocks} blocks of '
               f'{per_block} envs per SM = {blocks * per_block} resident envs per SM, '
               f'{smem} B of shared memory per block ({smem / per_block / 1024:.2f} KB '
               f'per env)')
    newton_abs_err, failures = agreement(dm, phase)
    if failures:
        raise AssertionError('; '.join(failures))
    run = main_path(dm, phase + 1, steps, windows, n_cpu)
    card_against_cpu(dm, run, phase + 2, cpu_cap)
    newton = newton_timing(run['last'], phase + 3, robot in ROUNDING_ROBOTS)
    device_profile(dm, run, phase + 4, profile_steps)
    narrow_phase_groups(dm, run, phase + 4)
    spd_fields[f'{prefix}launches'] = run['launches']['spd_solve']
    newton_fields.update({f'{prefix}launches': run['launches']['newton_fused'],
                          f'{prefix}max_abs_err': newton_abs_err,
                          **{prefix + k: v for k, v in newton.items()}})
    return run['steps_per_s']


def terrain_phases(spd_fields, newton_fields, rates):
    """Phases 35-39 (go2/perlin, BASELINE cfg2), 40 (its env with random
    velocity commands) and 41 (b2/perlin and hyqreal2/perlin)."""
    rates['go2', 'perlin'] = scene_phases(SCENES[5], spd_fields, newton_fields)
    run = env_main_path(rates['go2', 'perlin'], 40, 'perlin', 'random', 5, 36)
    spd_fields['env_perlin_launches'] = run['launches']['spd_solve']
    newton_fields['env_perlin_launches'] = run['launches']['newton_fused']
    del run
    for robot, launches in terrain_steps().items():
        spd_fields[f'{robot}_perlin_launches'] = launches['spd_solve']
        newton_fields[f'{robot}_perlin_launches'] = launches['newton_fused']


# ---- phases 42-46: the sensors (BASELINE cfg3) -----------------------------------------

# the device of phases 42-46: chip_rehearse.py sets 'cpu' to run them on the
# CPU at a small batch, with the torch.cuda calls stubbed
DEVICE = 'cuda'
# BASELINE cfg3's sensors and observables (examples/aliengo_with_sensors.py)
SENSOR_OBS = ('qpos', 'qvel', 'imu_acc', 'imu_gyro', 'imu_acc_bias', 'height_map_z')
IMU_KW = {'accel_noise': 0.01, 'gyro_noise': 0.01, 'accel_bias_rate': 0.01, 'gyro_bias_rate': 0.01}
IMU_QUIET = {k: 0.0 for k in IMU_KW}
HEIGHTMAP_KW = {'num_rows': 10, 'num_cols': 10, 'dist_x': 0.1, 'dist_y': 0.1}
CAMERA_KW = {'width': 64, 'height': 48, 'cam_name': 'robotcam'}
SENSOR_STEPS = 60
SENSOR_CPU_START = 50
# Phase 43, card f32 against CPU f64 over CPU_STEPS env steps at the Newton
# cap of 30, the largest difference over the steps relative to 1 + max|f64|.
# The bars are about 60-200 times what the CPU f32 run of the phase read
# (chip_rehearse.py, B=32): 0 (the floor is at 0), 1.7e-6 and 4.9e-6.
SENSOR_BARS = {'height_map_z': 1e-5, 'imu_gyro': 1e-4, 'imu_acc': 1e-3}
# Phase 45, card f32 against CPU f64 on 4 envs, on the pixels whose seg
# agrees and whose depth is under NEAR_DEPTH (m): depth and point cloud
# within DEPTH_REL_BAR of the depth. Farther pixels are grazing hits on the
# plane (kilometres away), where a ray's f32 direction moves the hit by ~1e-7 of
# depth^2 / camera height: reported apart. At most SEG_SHARE_BAR of the
# pixels may differ in seg (silhouettes, ties between geoms). The CPU f32
# run (chip_rehearse.py, B=32) found 1.6e-5 of the depth at most on the near
# pixels, 9.5e-5 on the far ones (up to 17 km), and no seg differing.
NEAR_DEPTH = 50.0
DEPTH_REL_BAR = 1e-3
SEG_SHARE_BAR = 1e-3
# Phase 42's accelerometer check. The reading less its bias and noise is the
# trunk's specific force within IMU_FORCE_BAR of 1 + its size (f32 rounding
# of two formulas). An env stands still in a step when its base moves slower
# than STILL_SPEED (m/s, rad/s) and accelerates less than STILL_ACC (m/s^2,
# rad/s^2); there the raw reading is 9.81 along the site's z within
# IMU_STILL_BAR: the noise (0.01) and the bias, a random walk of 0.01 a step
# (0.1 after 100 steps), plus the motion the thresholds let through.
IMU_FORCE_BAR = 1e-3
STILL_SPEED, STILL_ACC = 0.05, 0.5
IMU_STILL_BAR = 0.6


def sync():
    if torch.device(DEVICE).type == 'cuda':
        torch.cuda.synchronize()


def cfg3_env(dm, **over):
    """BASELINE cfg3's env on `dm`: forward commands U(0, 1) m/s, per-env
    friction U(0.5, 1.5), the IMU and the 10 x 10 heightmap, the example's
    six observables; `over` replaces any of these arguments."""
    kw = dict(scene=dm.m.scene, model=dm, base_vel_command_type='forward',
              ref_base_lin_vel=(0.0, 1.0), ground_friction_coeff=(0.5, 1.5),
              state_obs_names=SENSOR_OBS, sensors=(IMU, HeightMap),
              sensors_kwargs=(IMU_KW, HEIGHTMAP_KW))
    kw.update(over)
    return QuadrupedEnv(dm.m.robot, **kw)


def check_obs(env, obs, where):
    """Every observable finite and of its observation_space_dims width."""
    dims = env.observation_space_dims()
    for name, v in obs.items():
        if v.shape[1:] != (dims[name],):
            raise AssertionError(f'{where}: observable {name} of shape {tuple(v.shape)}, '
                                 f'expected (B, {dims[name]})')
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f'{where}: observable {name} is not finite')


def sensors_range_ms(env, state, action, gen, n_steps=3):
    """(host ms, device ms) per env.step of the profiler range `sensors`,
    over n_steps steps, or None where the profiler saw no device time."""
    return range_ms(lambda: env.step(state, action, gen), 'sensors', n_steps)


def imu_against_rigid_body(env, state, actions, gen, n):
    """n more steps of the cfg3 env, the accelerometer held against the
    trunk's rigid-body motion: at every env, the reading less its bias and
    noise against the site's specific force R_site^T (a + alpha x r + omega
    x (omega x r) + 9.81 z), a, omega and alpha the base's from the free
    joint's qvel and the step's qacc, r the site's offset from the base (a
    formula apart from the IMU's spatial-vector chain), relative to 1 + its
    size; and the envs standing still (base speed under STILL_SPEED and
    acceleration under STILL_ACC, linear and angular) read +9.81 along the
    site's z within IMU_STILL_BAR, noise and bias included. Returns (max
    relative diff, env-steps standing still, max |imu_acc - 9.81 z_site|
    there)."""
    dm = env.model
    imu = env.sensors[0]
    base = int(dm.m.jnt_bodyid[0])
    if imu.body_id != base:
        raise AssertionError('the IMU site is not on the free-joint body')
    g = torch.tensor([0.0, 0.0, 9.81], dtype=dm.dtype, device=DEVICE)
    cross = torch.linalg.cross
    worst, still, worst_still = 0.0, 0, 0.0
    for t in range(n):
        prev = state
        state, obs = env.step(state, actions[t], gen)[:2]
        kin = kinematics.fk(dm, prev.qpos)
        R_site, Rb = kin.site_xmat[:, imu.site_id], kinematics.quat_to_mat(prev.qpos[:, 3:7])
        w = (Rb @ prev.qvel[:, 3:6, None])[..., 0]
        alpha = (Rb @ state.qacc[:, 3:6, None])[..., 0]
        r = kin.site_xpos[:, imu.site_id] - prev.qpos[:, :3]
        a = state.qacc[:, :3] + cross(alpha, r) + cross(w, cross(w, r)) + g
        force = (a[:, :, None] * R_site).sum(1)                        # R_site^T a
        ss = state.sensors[0]
        diff = (ss.acc - ss.acc_bias - ss.acc_noise - force).abs().amax(-1)
        worst = max(worst, (diff / (1 + force.abs().amax(-1))).max().item())
        standing = ((prev.qvel[:, :6].abs().amax(-1) < STILL_SPEED)
                    & (state.qacc[:, :6].abs().amax(-1) < STILL_ACC))
        still += int(standing.sum())
        if bool(standing.any()):
            rest = (obs['imu_acc'] - 9.81 * R_site[:, 2, :]).abs().amax(-1)
            worst_still = max(worst_still, rest[standing].max().item())
    return worst, still, worst_still


def sensors_main_path(phase=42, B=BATCH, steps=SENSOR_STEPS):
    """Phase 42: BASELINE cfg3, aliengo/flat through QuadrupedEnv with the IMU
    (noise and bias rate 0.01) and the 10 x 10 heightmap, the example's six
    observables, per-env friction U(0.5, 1.5): a random reset of B envs,
    then `steps` env.step with seeded U(-2, 2) torques and the generator.
    Beside it the same env without sensors from the same state in this
    call, so that the sensors' cost per step is one subtraction; the
    sensors' host and device ms (profiler range `sensors`); peak memory.
    Checks: exactly 2 SPD and 1 Newton launch per step (counts set to 0 just
    before the steps and read just after), no more host syncs than the
    sensorless env.step, every observable finite and of its dim,
    height_map_z 0 on the flat floor, and on envs standing still imu_acc
    near +9.81 along the site's z. Keeps N_CPU_ENVS envs at step
    SENSOR_CPU_START for phase 43; times both kernels on the last step."""
    dm = load_model('aliengo', 'flat', device=DEVICE)
    env, bare = cfg3_env(dm), cfg3_env(dm, state_obs_names=('qpos', 'qvel'), sensors=None)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, obs = env.reset(gen, B)
    sync()
    reset_s = time.perf_counter() - t0
    log(phase, f'aliengo/flat env with IMU and HeightMap, reset B={B}: {reset_s:.3f} s, '
               f'{env.lift_rounds} rounds of the lift out of contact; on {smi()}')
    actions = torch.rand(steps + 10, B, dm.m.nu, generator=gen, device=DEVICE) * 4.0 - 2.0
    plain = dataclasses.replace(state, sensors=())

    def run_bare(plain, ts):        # with the main path's finiteness checks
        ok = torch.ones((), dtype=torch.bool, device=DEVICE)
        sync()
        t0 = time.perf_counter()
        for t in ts:
            plain, o = bare.step(plain, actions[t])[:2]
            ok &= all_finite(plain, o)
        sync()
        if not bool(ok):
            raise AssertionError('a state of the sensorless cfg3 env is not finite')
        return plain, time.perf_counter() - t0

    # the sensorless env runs half its steps before the main path, half after
    plain, bare_before = run_bare(plain, range(steps // 2))
    finite = all_finite(state, obs)
    per_step, kept = [], None
    sync()
    spd.launches = nf.launches = 0
    t0 = time.perf_counter()
    for t in range(steps):
        if t == SENSOR_CPU_START:
            kept = state.map(lambda x: x[:N_CPU_ENVS].clone())
        before = spd.launches, nf.launches
        prev = state
        state, obs, reward, term, trunc, info = env.step(state, actions[t], gen)
        per_step.append((spd.launches - before[0], nf.launches - before[1]))
        finite &= all_finite(state, obs)
    sync()
    wall = time.perf_counter() - t0
    launches = {'spd_solve': spd.launches, 'newton_fused': nf.launches}
    plain, bare_after = run_bare(plain, range(steps // 2, steps))
    rate = steps / wall
    bare_rate = (steps // 2 * 2) / (bare_before + bare_after)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(phase, f'aliengo/flat env.step with sensors B={B} f32: {steps} steps in {wall:.3f} s = '
               f'{rate:.3f} steps/s = {B * rate:.1f} env-steps/s; without sensors in this call, '
               f'{steps // 2} steps before and {steps // 2} after: {bare_rate:.3f} steps/s = '
               f'{B * bare_rate:.1f} env-steps/s ({1e3 * bare_before / (steps // 2):.2f} and '
               f'{1e3 * bare_after / (steps // 2):.2f} ms per step; with/without '
               f'{rate / bare_rate:.3f}, the sensors cost {1e3 / rate - 1e3 / bare_rate:.2f} ms '
               f'per step); peak device memory from the reset on {peak:.3f} GiB; on {smi()}')
    log(phase, f'launches: spd_solve {launches["spd_solve"]}, newton_fused '
               f'{launches["newton_fused"]} (per step {sorted(set(per_step))}); terminated at the '
               f'last step {int(term.sum())} of {B}; mean base height '
               f'{state.qpos[:, 2].mean().item():.4f}')
    if not bool(finite):
        raise AssertionError('a state or observation of the cfg3 env is not finite')
    if any(k != (2, 1) for k in per_step):
        raise AssertionError(f'expected 2 spd_solve and 1 newton_fused launch per env.step, got '
                             f'{sorted(set(per_step))}')
    check_obs(env, obs, 'aliengo/flat with sensors')
    if not bool((obs['height_map_z'] == 0).all()):
        raise AssertionError('height_map_z is not 0 on the flat floor')
    host, device = sensors_range_ms(env, state, actions[-1], gen)
    action = actions[-1]
    one = {'with': [], 'without': []}
    for _ in range(5):        # one synchronised env.step each, in turns
        one['with'].append(host_ms(lambda: env.step(state, action, gen), repeats=1))
        one['without'].append(host_ms(lambda: bare.step(plain, action), repeats=1))
    one = {k: float(np.median(v)) for k, v in one.items()}
    log(phase, f'profiler range sensors (IMU and HeightMap) per env.step: host '
               f'{host:.3f} ms, device {device if device is None else f"{device:.3f}"} ms; one '
               f'synchronised env.step, in turns (median of 5): with sensors {one["with"]:.2f} ms, '
               f'without {one["without"]:.2f} ms; on {smi()}')
    env_syncs = sync_count(lambda: env.step(state, action, gen))
    bare_syncs = sync_count(lambda: bare.step(dataclasses.replace(state, sensors=()), action))
    log(phase, f'host synchronisations reported per call: env.step with sensors {env_syncs[0]}, '
               f'without {bare_syncs[0]} (first: {env_syncs[1] or bare_syncs[1]})')
    if env_syncs[0] > bare_syncs[0]:
        raise AssertionError(f'the sensors add host syncs: {env_syncs} against {bare_syncs}')
    worst, still, worst_still = imu_against_rigid_body(env, state, actions[steps:], gen, 10)
    log(phase, f'10 more steps: imu_acc less its bias and noise against the trunk\'s specific '
               f'force R_site^T (a + alpha x r + omega x (omega x r) + g), every env: max diff '
               f'{worst:.3e} of 1 + |force| (bar {IMU_FORCE_BAR}); standing still {still} '
               f'env-steps, there imu_acc against 9.81 along the site\'s z: max |diff| '
               f'{worst_still:.4f} m/s^2 (bar {IMU_STILL_BAR})')
    if not (worst < IMU_FORCE_BAR and worst_still < IMU_STILL_BAR):
        raise AssertionError(f'imu_acc off the specific force by {worst}, standing still by '
                             f'{worst_still} ({still} env-steps)')
    # both kernels on the last step's inputs
    fwd = engine.forward(dm, prev.qpos, prev.qvel, actions[steps - 1], warmstart=prev.qacc,
                         con_mu=runtime_con_mu(dm, prev.geom_friction))
    x = torch.empty_like(fwd.qfrc_smooth)
    args = (fwd.M.data_ptr(), fwd.qfrc_smooth.data_ptr(), x.data_ptr(), B, dm.m.nv,
            torch.cuda.current_stream().cuda_stream)
    spd_ms = median_ms(lambda: spd._library(dm.m.nv).gqt_spd_solve_f32(*args))
    log(phase, f'SPD kernel on the last step\'s M (B={B}, n={dm.m.nv}): {spd_ms:.4f} ms; on {smi()}')
    newton = newton_timing((fwd.M, fwd.qacc_smooth, fwd.efc, prev.qacc), phase)
    return {'env': env, 'gen': gen, 'state': state, 'actions': actions, 'kept': kept,
            'launches': launches, 'spd_ms': spd_ms, 'newton': newton}


def sensor_obs_err(card, cpu):
    """{name: max |card - cpu| / (1 + max|cpu|)} over a list of steps' obs."""
    out = {}
    for name in card[0]:
        c = torch.stack([o[name] for o in card]).double().cpu()
        f = torch.stack([o[name] for o in cpu])
        out[name] = ((c - f).abs().max() / (1 + f.abs().max())).item()
    return out


def sensors_card_against_cpu(run, phase=43, cap=GO2_AGREEMENT_ITERATIONS):
    """Phase 43: the N_CPU_ENVS envs kept at step SENSOR_CPU_START, the IMU's
    noise set to 0, moved along the floor to the origin, stepped CPU_STEPS
    times through env.step on the card (f32) and on the CPU (f64) at a
    Newton cap of `cap`: qpos within 1e-3 at the end, height_map_z, imu_gyro
    and imu_acc within SENSOR_BARS over every step. The cap-10 readings
    beside them."""
    torch.set_num_threads(1)
    env, actions = run['env'], run['actions']
    start = run['kept'].map(torch.clone)
    start.qpos[:, :2] = 0.0
    t0 = SENSOR_CPU_START
    acts = actions[t0:t0 + CPU_STEPS, :N_CPU_ENVS]
    kw = {it: dict(solver_iterations=it, sensors_kwargs=(IMU_QUIET, HEIGHTMAP_KW))
          for it in (cap, 10)}
    card = {}
    for it in (cap, 10):
        s, obs = start, []
        step = cfg3_env(env.model, **kw[it]).step
        for a in acts:
            s, o = step(s, a)[:2]
            obs.append(o)
        card[it] = s, obs

    def finish(cpu):
        out = {}
        for it in (cap, 10):
            q = (card[it][0].qpos.double().cpu() - cpu[it][0].qpos).abs().max().item()
            out[it] = q, sensor_obs_err(card[it][1], cpu[it][1])
        fmt = lambda e: ', '.join(f'{k} {v:.3e}' for k, v in e.items() if k != 'qpos')
        log(phase, f'aliengo/flat env with sensors, {N_CPU_ENVS} envs moved to the origin, steps '
                   f'{t0}..{t0 + CPU_STEPS}, card f32 vs CPU f64: Newton cap {cap}: max |qpos '
                   f'diff| {out[cap][0]:.3e}; max diff over the steps of 1 + max|f64|: '
                   f'{fmt(out[cap][1])}; at the cap of 10: qpos {out[10][0]:.3e}, '
                   f'{fmt(out[10][1])}', late=True)
        if not out[cap][0] < 1e-3:
            raise AssertionError(f'cfg3 env: card and CPU trajectories differ by {out[cap][0]}')
        for name, bar in SENSOR_BARS.items():
            if not out[cap][1][name] < bar:
                raise AssertionError(f'cfg3 env: {name} of the card off the CPU f64 by '
                                     f'{out[cap][1][name]} (bar {bar})')

    later_all([(cpu_env_steps, ('aliengo', 'flat', kw[it], start.to('cpu', torch.float64),
                                acts.double().cpu(), True)) for it in (cap, 10)],
              lambda results: finish(dict(zip((cap, 10), results))))


def terrain_sensors(phase=44, B=BATCH, steps=5):
    """Phase 44: heightmaps on terrain. aliengo/perlin's env with the IMU and
    the heightmap: random reset of B envs, `steps` steps, env-steps/s, peak
    memory, 2 SPD + 1 Newton launches per step; every env's height_map_z
    against the heightfield's own height at the grid points' x and y (the
    hfield geom's pose applied; vertical rays are exact, so the bar is f32
    rounding of the origin's z). Then hyqreal2/random_boxes' env with the
    heightmap alone: `steps` steps at B, each casting B x 100 rays against
    the plane and 100 boxes; its reset's lift is phase 34's where the drawn
    pose is the same (`memo_lift`). Returns {'perlin_state': (the perlin
    env's model, its last state), scene: launches}."""
    out = {}
    for robot, scene, sensors, kw in (('aliengo', 'perlin', (IMU, HeightMap), (IMU_KW, HEIGHTMAP_KW)),
                                      ('hyqreal2', 'random_boxes', (HeightMap,), (HEIGHTMAP_KW,))):
        dm = load_model(robot, scene, device=DEVICE)
        names = ('qpos', 'qvel') + tuple(n for n in SENSOR_OBS[2:]
                                         if n.startswith('height') or robot == 'aliengo')
        env = cfg3_env(dm, state_obs_names=names, sensors=sensors, sensors_kwargs=kw)
        memo_lift(env, (robot, scene))
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, obs = env.reset(gen, B)
        sync()
        reset_s = time.perf_counter() - t0
        actions = torch.rand(steps, B, dm.m.nu, generator=gen, device=DEVICE) * 4.0 - 2.0
        finite = all_finite(state, obs)
        sync()
        spd.launches = nf.launches = 0
        t0 = time.perf_counter()
        for t in range(steps):
            prev = state
            state, obs = env.step(state, actions[t], gen)[:2]
            finite &= all_finite(state, obs)
        sync()
        wall = time.perf_counter() - t0
        launches = {'spd_solve': spd.launches, 'newton_fused': nf.launches}
        hm = obs['height_map_z']
        log(phase, f'{robot}/{scene} env with {"IMU and " if robot == "aliengo" else ""}HeightMap '
                   f'B={B}: reset {reset_s:.3f} s ({env.lift_rounds} lift rounds'
                   f'{", the lift of phase 34 served: the same draw" if env.lift_served else ""}); '
                   f'{steps} env.steps '
                   f'in {wall:.3f} s = {steps / wall:.3f} steps/s = {B * steps / wall:.1f} '
                   f'env-steps/s; launches spd_solve {spd.launches}, newton_fused {nf.launches}; '
                   f'height_map_z in [{hm.min().item():.4f}, {hm.max().item():.4f}]; peak device '
                   f'memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; on {smi()}')
        if not bool(finite):
            raise AssertionError(f'a state or observation of the {robot}/{scene} env is not finite')
        if (spd.launches, nf.launches) != (2 * steps, steps):
            raise AssertionError(f'{robot}/{scene} env: launches {spd.launches}, {nf.launches}')
        check_obs(env, obs, f'{robot}/{scene} with sensors')
        if scene == 'perlin':
            m = dm.m
            hmap = env.sensors[1]
            pts = hmap.grid_points(prev.qpos)                          # the rays' origins
            h = int(np.flatnonzero(m.geom_type == GEOM_HFIELD)[0])
            if not np.array_equal(m.geom_quat[h], [1.0, 0.0, 0.0, 0.0]):
                raise AssertionError('the heightfield geom is rotated: the check takes it level')
            g = torch.as_tensor(m.geom_pos[h], dtype=dm.dtype, device=DEVICE)
            lx, ly = pts[..., 0] - g[0], pts[..., 1] - g[1]
            inside = (lx.abs() <= dm.hfield_size[0]) & (ly.abs() <= dm.hfield_size[1])
            ground = torch.where(inside, collision.hfield_height(dm, lx, ly) + g[2], 0.0)
            ground = torch.maximum(ground, torch.zeros_like(ground))   # the plane at z = 0
            err = (hm.reshape(ground.shape) - ground).abs().max().item()
            bar = 4 * torch.finfo(torch.float32).eps * (1 + pts[..., 2].abs().max().item())
            log(phase, f'aliengo/perlin height_map_z against the heightfield at the grid points '
                       f'({B} envs x {hm.shape[1]} cells, {inside.float().mean().item():.4f} on the '
                       f'field): max |diff| {err:.3e} m (bar {bar:.3e}, f32 rounding of the '
                       f'origin z)')
            if not err < bar:
                raise AssertionError(f'aliengo/perlin heightmap off the heightfield by {err}')
            out['perlin_state'] = (dm, state)
        out[scene] = launches
    return out


def render_shares(dm, seg):
    """(share of pixels on the world's geoms, on the robot's, none)."""
    world = torch.as_tensor(world_geoms(dm.m), device=seg.device)
    on_world = torch.isin(seg, world)
    return (on_world.float().mean().item(), ((seg >= 0) & ~on_world).float().mean().item(),
            (seg < 0).float().mean().item())


def camera_renders(scenes, phase=45, n_cpu=4):
    """Phase 45: Camera(64 x 48, robotcam).render of every env of phase 42's
    last state (flat) and phase 44's (perlin): ms per render (CUDA events),
    peak memory, depth finite and >= 0, seg ids in [-1, ngeom), the shares of
    pixels on the terrain and on the robot; then n_cpu envs (on flat moved to
    the origin) rendered in f64 on the CPU: depth and point cloud within
    DEPTH_REL_BAR of the depth on the near pixels whose seg agrees, the
    share whose seg differs under SEG_SHARE_BAR. Returns {scene: ms per
    render}."""
    torch.set_num_threads(1)
    out = {}
    for scene, (dm, state) in scenes.items():
        m = dm.m
        cam = Camera(dm, **CAMERA_KW)
        kin = kinematics.fk(dm, state.qpos)
        B = state.qpos.shape[0]
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        depth, depth_p, seg, pc = cam.render(kin)
        sync()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        ms = median_ms(lambda: cam.render(kin), launches=1, repeats=3)
        world, robot, sky = render_shares(dm, seg)
        log(phase, f'aliengo/{scene} Camera {cam.width} x {cam.height} render of {B} envs '
                   f'({B * cam.width * cam.height} rays): {ms:.2f} ms per render, peak device '
                   f'memory above its inputs {peak:.3f} GiB; pixels on the terrain {world:.4f}, on '
                   f'the robot {robot:.4f}, none {sky:.4f}; on {smi()}')
        if not (bool(torch.isfinite(depth).all()) and bool((depth >= 0).all())
                and bool(torch.isfinite(pc).all())):
            raise AssertionError(f'aliengo/{scene} depth not finite or negative')
        if not (int(seg.min()) >= -1 and int(seg.max()) < m.ngeom):
            raise AssertionError(f'aliengo/{scene} seg ids out of [-1, {m.ngeom})')
        qpos = state.qpos[:n_cpu].clone()
        if scene == 'flat':
            qpos[:, :2] = 0.0            # the flat floor is the same everywhere
        dm64 = load_model('aliengo', scene, device='cpu', dtype=torch.float64)
        got = Camera(dm, **CAMERA_KW).shoot(qpos)
        want = Camera(dm64, **CAMERA_KW).shoot(qpos.double().cpu())
        agree = got[2].cpu() == want[2]
        near = agree & (want[0] < NEAR_DEPTH)
        far = agree & ~near
        depth = want[0].clamp_min(1e-9)
        d_rel = (got[0].double().cpu() - want[0]).abs() / depth
        pc_rel = (got[3].double().cpu() - want[3]).norm(dim=-1).reshape(depth.shape) / depth
        worst = lambda x, mask: x[mask].max().item() if bool(mask.any()) else 0.0
        differ = 1.0 - agree.float().mean().item()
        log(phase, f'aliengo/{scene}, {n_cpu} envs: card f32 vs CPU f64 on the {int(near.sum())} '
                   f'pixels whose seg agrees nearer than {NEAR_DEPTH:g} m: depth '
                   f'{worst(d_rel, near):.3e}, point cloud {worst(pc_rel, near):.3e} of the depth '
                   f'(bar {DEPTH_REL_BAR}); the {int(far.sum())} farther (grazing the plane, up to '
                   f'{worst(want[0], far):.1f} m): depth {worst(d_rel, far):.3e} of the depth; '
                   f'pixels whose seg differs {int((~agree).sum())} of {agree.numel()} = '
                   f'{differ:.5f} (bar {SEG_SHARE_BAR})')
        if not (worst(d_rel, near) < DEPTH_REL_BAR and worst(pc_rel, near) < DEPTH_REL_BAR
                and differ < SEG_SHARE_BAR):
            raise AssertionError(f'aliengo/{scene} camera: the card and the CPU disagree')
        out[scene] = ms
    return out


def camera_env(phase=46, B=BATCH, steps=50):
    """Phase 46: the aliengo/flat env with a Camera(64 x 48, robotcam,
    auto_render=True, fps=30): `steps` env.steps; the renders per env
    (last_time moves) against the reference's rule on the host (render when
    1/fps has passed since the last render, f32 clocks), 2 SPD + 1 Newton
    launches per step; then rollout_with_sensors from the same reset state,
    rendering every chunk of steps the rule's cadence gives, over the
    states the auto-render saw: the same depth."""
    dm = load_model('aliengo', 'flat', device=DEVICE)
    env = cfg3_env(dm, state_obs_names=('qpos', 'qvel', 'depth_image'), sensors=(Camera,),
                   sensors_kwargs=({**CAMERA_KW, 'fps': 30.0, 'auto_render': True},))
    cam = env.sensors[0]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    state0, obs = env.reset(gen, B)
    actions = torch.rand(steps, B, dm.m.nu, generator=gen, device=DEVICE) * 4.0 - 2.0
    renders = torch.zeros(B, dtype=torch.int64, device=DEVICE)
    rendered = {}
    state = state0
    sync()
    spd.launches = nf.launches = 0
    t0 = time.perf_counter()
    for t in range(1, steps + 1):
        last = state.sensors[0].last_time
        state, obs = env.step(state, actions[t - 1])[:2]
        moved = state.sensors[0].last_time != last
        renders += moved
        rendered[t] = (moved.all(), moved.any(), state.sensors[0].depth)
    sync()
    wall = time.perf_counter() - t0
    launches = {'spd_solve': spd.launches, 'newton_fused': nf.launches}
    # the rule on the host, in f32 as on the card: the reset reads once
    dt, interval = np.float32(dm.timestep), np.float32(cam.interval - 1e-9)
    clock, last, expect = dt, dt, []
    for t in range(1, steps + 1):
        clock = np.float32(clock + dt)
        if np.float32(clock - last) >= interval:
            expect.append(t)
            last = clock
    got = [t for t, (all_, any_, _) in rendered.items() if bool(any_)]
    log(phase, f'aliengo/flat env with an auto-rendering camera B={B}: {steps} env.steps in '
               f'{wall:.3f} s = {steps / wall:.3f} steps/s = {B * steps / wall:.1f} env-steps/s; '
               f'renders at steps {got} in every env {bool((renders == len(expect)).all())}, the '
               f'rule\'s {expect}; launches spd_solve {spd.launches}, newton_fused {nf.launches}; '
               f'on {smi()}')
    if got != expect or not all(bool(rendered[t][0]) for t in expect) \
            or not bool((renders == len(expect)).all()):
        raise AssertionError(f'camera renders at {got}, the rule at {expect}')
    if (spd.launches, nf.launches) != (2 * steps, steps):
        raise AssertionError(f'camera env: launches {spd.launches}, {nf.launches}')
    chunk = expect[0]
    if any(t % chunk for t in expect):
        raise AssertionError(f'the rule\'s renders {expect} are not every {chunk} steps')
    n = chunk * len(expect)
    # the carried state is (env state, the qpos before its last step): the
    # render after each chunk sees what the auto-render saw in its last step
    _, seq = rollout_with_sensors(lambda c, a: ((env.step(c[0], a)[0], c[0].qpos),),
                                  (state0, state0.qpos), actions[:n],
                                  lambda c: cam.shoot(c[1])[0], chunk)
    err = max((seq[i] - rendered[t][2]).abs().max().item() for i, t in enumerate(expect))
    log(phase, f'rollout_with_sensors rendering every {chunk} steps over the same states: '
               f'max |depth diff| against the auto-render {err:.3e} m')
    if not err < 1e-4:
        raise AssertionError(f'rollout_with_sensors depth off the auto-render by {err}')
    return launches


def sensor_phases(spd_fields, newton_fields):
    """Phases 42-46: BASELINE cfg3 (aliengo/flat with IMU and heightmap),
    card against CPU, heightmaps on terrain, the depth camera and the
    camera through the env."""
    run = sensors_main_path()
    sensors_card_against_cpu(run)
    spd_fields['aliengo_sensors_launches'] = run['launches']['spd_solve']
    spd_fields['aliengo_sensors_last_step_ms'] = run['spd_ms']
    newton_fields['aliengo_sensors_launches'] = run['launches']['newton_fused']
    newton_fields.update({'aliengo_sensors_' + k: v for k, v in run['newton'].items()})
    flat = (run['env'].model, run['state'])
    del run
    terrain = terrain_sensors()
    for scene, prefix in (('perlin', 'aliengo_perlin_sensors_'),
                          ('random_boxes', 'random_boxes_heightmap_')):
        spd_fields[prefix + 'launches'] = terrain[scene]['spd_solve']
        newton_fields[prefix + 'launches'] = terrain[scene]['newton_fused']
    camera_renders({'flat': flat, 'perlin': terrain['perlin_state']})
    del flat, terrain
    launches = camera_env()
    spd_fields['camera_env_launches'] = launches['spd_solve']
    newton_fields['camera_env_launches'] = launches['newton_fused']


# ---- phases 47-50: the centroidal MPC and MPPI on go2/flat ------------------------------

# bench.py's MPC recipe: feet fixed under the hips, the keyframe with 0.01
# noise, qvel 0.1 noise, t U(0, 1), a forward command of 0.4 m/s
MPC_FEET0 = ((0.19, 0.14, 0.02), (0.19, -0.14, 0.02), (-0.19, 0.14, 0.02), (-0.19, -0.14, 0.02))
# Newton-Schulz residual ||I - XK||_F per env. The reference's docstring
# gives ~2e-3 in f32 (gym_quadruped_tpu/mpc/qp.py:161); on this phase's
# states its own f32 iteration reads more, and the port's no more than it
# (tests/test_torch_mpc.py::test_spd_inverse_f32_floor): the p99 is held
# to NS_RESID_BAR, and every env to NS_RESID_MAX (the card's tail reads
# 1.196e-02, PERF.md). TF32's 10-bit mantissa floors the same iteration
# near 0.2-0.4 (the unpinned line shows it).
NS_RESID_BAR = 1e-2
NS_RESID_MAX = 3e-2
# the card's first-knot forces against the port's f64 CPU solve, relative to
# the f64 force scale: the reference's Newton-Schulz against LU gap is 4e-3 N
# on 165 N (2.4e-5)
MPC_F64_BAR = 1e-3
MPC_STEPS = 121
MPC_REPLAN = 5
MPC_CPU_START = 100
MPC_CPU_ENVS = 4
UPRIGHT_SHARE = 0.9
# MPPI's rollouts run the Newton solve at a cap of 4, where most solves stop
# unconverged and the line search's bisection (a sign test per halving)
# makes the iterate a step function of rounding. So at that cap the kernel
# is held to the eager f32 solve, the same arithmetic in the same
# precision, twice, with bars from the readings of an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md, PR 9), each printed beside what a kernel that
# stopped one iteration early or late reads:
# (1) on each of the 24 Newton solves of the 1,024 rollouts, on the inputs
# the kernel's rollouts gave it: iteration counts differ in at most
# ITERATION_ENVS_BAR of the env-steps (read 2 of 24,576; at caps 3 and 5
# 98.8% and 98.3%), and the median env's qacc gap is at most
# MPPI_STEP_MEDIAN_BAR of 1 + max|qacc| (read 2.4e-05; the eager f32 solve
# against the eager f64 one is printed beside it; at caps 3 and 5 1.0e-02
# and 5.5e-04).
# (2) 8 rollouts' costs, the engine once on the kernel and once on the
# eager f32 solve: within MPPI_CAP4_COST_BAR relative (read 3.148e-02, the
# eager f32 solve 2.566e-02 from f64 on the CPU; the eager solve at caps 3
# and 5 moves them 2.570e-01 and 1.914e-01).
# At a cap of 30 the solves converge and the 8 rollouts' costs, card f32
# against CPU f64, are held to MPPI_COST_BAR (read 3.798e-07).
MPPI_COST_BAR = 1e-5
MPPI_STEP_MEDIAN_BAR = 1e-4
MPPI_CAP4_COST_BAR = 6e-2


def mpc_flop(B, H, admm_iterations):
    """Operations of B solves: the condensing (H running-row products, Su^T
    Q Su and its vector), Newton-Schulz (2 products of n x n per iteration)
    and the ADMM's matrix-vector products, n = 12 H."""
    n, nx = 12 * H, NX
    condense = H * 2 * (nx ** 3 + nx * nx * n) + 2 * n * H * nx * n + 2 * n * H * nx
    return B * (condense + qp._NS_ITERS * 4 * n ** 3 + admm_iterations * 2 * n * n)


def range_ms(run, name, n=1):
    """(host ms, device ms) per call of run(), which records the profiler
    range `name` (device None where the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        sync()
    cuda = torch.autograd.DeviceType.CUDA
    ev = [e for e in prof.key_averages() if e.key == name and e.device_type != cuda]
    if not ev:
        return None, None
    dev_ms = ev[0].device_time_total / 1e3 / n
    return ev[0].cpu_time_total / 1e3 / n, (dev_ms if dev_ms > 0 else None)


def named(fn, name):
    def run():
        with record_function(name):
            fn()
    return run


def ns_residuals(mpc, inputs):
    """Each env's ||I - X K||_F of the Newton-Schulz inverse of its ADMM
    matrix K = Hq + rho I, the product in f64."""
    Hq, _, schedule = mpc.condensed_qp(*inputs)
    n = Hq.shape[1]
    K = Hq + mpc.cfg.rho * torch.eye(n, dtype=Hq.dtype, device=Hq.device)
    X = qp.spd_inverse(K, qp.swing_components(schedule))
    eye = torch.eye(n, dtype=torch.float64, device=Hq.device)
    return torch.linalg.matrix_norm(eye - X.double() @ K.double())


def mpc_solves(phase=47, B=BATCH):
    """Phase 47: CentroidalMPC.solve on go2/flat at H=12 and B envs by
    bench.py's recipe: cold (30 ADMM iterations) and warm (10) solves/s
    from synchronised host medians, host and device ms (profiler range),
    tensor operations and host syncs per solve (0), peak memory, the bound;
    each env's Newton-Schulz residual (p99 at most NS_RESID_BAR, every env
    NS_RESID_MAX), again with TF32 globally on; the first-knot forces of MPC_CPU_ENVS x 4 envs against
    the port's f64 CPU solve (MPC_F64_BAR). Returns the warm solves/s."""
    dm = load_model('go2', 'flat', device=DEVICE)
    m = dm.m
    cfg = MPCConfig(gait=GaitConfig('trot'), iterations=30)
    mpc = CentroidalMPC(dm, cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    qpos = torch.as_tensor(m.key_qpos[0], dtype=torch.float32, device=DEVICE).repeat(B, 1)
    qpos = qpos + 0.01 * torch.randn(B, m.nq, generator=gen, device=DEVICE)
    qvel = 0.1 * torch.randn(B, m.nv, generator=gen, device=DEVICE)
    t = torch.rand(B, generator=gen, device=DEVICE)
    feet = torch.tensor(MPC_FEET0, device=DEVICE).expand(B, 4, 3)
    ref = torch.tensor([0.4, 0.0, 0.0], device=DEVICE).expand(B, 3)
    inputs = (qpos, qvel, feet, t, ref, torch.zeros(B, device=DEVICE))
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    forces, warm0 = mpc.solve(*inputs)
    sync()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    rates = {}
    for form, warm in (('cold', None), ('warm', warm0)):
        fn = functools.partial(mpc.solve, *inputs, warmstart=warm)
        with OpCount() as ops:
            fn()
        syncs = sync_count(fn)
        host = host_ms(fn, repeats=5)
        prof_host, dev = range_ms(named(fn, 'mpc_solve'), 'mpc_solve')
        iters = cfg.iterations if warm is None else cfg.warm_iterations
        flop = mpc_flop(B, cfg.horizon, iters)
        n_bytes = B * 4 * (m.nq + m.nv + 12 + 1 + 3 + 1 + 12 * cfg.horizon * (1 + 3)
                           + (3 * 12 * cfg.horizon if warm is not None else 0))
        bound_ms, bound_by = bound(n_bytes, flop)
        rates[form] = B / host * 1e3
        log(phase, f'go2/flat MPC H={cfg.horizon} B={B} {form} ({iters} ADMM iterations): '
                   f'{rates[form]:.1f} solves/s ({host:.3f} ms per solve, synchronised host '
                   f'median of 5); profiler range: host {prof_host or 0:.3f} ms, device '
                   f'{"not measured" if dev is None else f"{dev:.3f} ms"}; {ops.count} tensor '
                   f'operations per solve; host syncs {syncs[0]}; bound {bound_ms:.3f} ms '
                   f'({bound_by}: {flop / 1e12:.4f} TFLOP, {n_bytes / 1e6:.2f} MB in and out; '
                   f'Newton-Schulz moves {qp._NS_ITERS * 2 * 3 * (12 * cfg.horizon) ** 2 * 4 * B / 1e9:.1f} '
                   f'GB between products) = {host / bound_ms:.1f}x; on {smi()}')
        if syncs[0]:
            raise AssertionError(f'the {form} MPC solve synchronises with the host: {syncs[1]}')
    log(phase, f'peak device memory of a cold solve above its inputs {peak:.3f} GiB; on {smi()}')

    resid = ns_residuals(mpc, inputs)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        resid_tf32 = ns_residuals(mpc, inputs)
        with mock.patch.object(qp, 'full_f32', contextlib.nullcontext):
            unpinned = ns_residuals(mpc, inputs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    q = lambda r: (f'median {r.median().item():.3e}, p99 {r.quantile(0.99).item():.3e}, '
                   f'max {r.max().item():.3e}')
    log(phase, f'Newton-Schulz ||I - XK||_F per env: {q(resid)}; with TF32 globally on '
               f'{q(resid_tf32)} (the loop pinned to full f32; unpinned it reads '
               f'{q(unpinned)}); bars: p99 {NS_RESID_BAR}, every env {NS_RESID_MAX}')
    for r, where in ((resid, ''), (resid_tf32, ' with TF32 on')):
        if not (r.quantile(0.99) <= NS_RESID_BAR and r.max() <= NS_RESID_MAX):
            raise AssertionError(f'Newton-Schulz residual{where}: {q(r)}')

    dm64 = load_model('go2', 'flat', device='cpu', dtype=torch.float64)
    mpc64 = CentroidalMPC(dm64, cfg)
    f64 = mpc64.solve(*(x[:N_CPU_ENVS].double().cpu() for x in inputs))[0][:, 0]
    err = (forces[:N_CPU_ENVS, 0].double().cpu() - f64).abs().max().item()
    scale = f64.abs().max().item()
    log(phase, f'first-knot forces of {N_CPU_ENVS} envs, card f32 against CPU f64: max |diff| '
               f'{err:.3e} N on a force scale of {scale:.1f} N = {err / scale:.3e} (bar '
               f'{MPC_F64_BAR})')
    if not err / scale <= MPC_F64_BAR:
        raise AssertionError(f'MPC forces: card and f64 CPU differ by {err / scale:.3e} of the scale')
    return rates['warm']


def closed_loop_config():
    """The example's controller: trot of period 0.5 s, 50 cold ADMM
    iterations, 10 warm."""
    return MPCConfig(gait=GaitConfig('trot', period=0.5), iterations=50)


def mpc_closed_loop(warm_rate, phase=48, B=BATCH, steps=MPC_STEPS):
    """Phase 48: go2/flat's env at B envs trotting under the MPC: an
    explicit reset from the keyframe with the joints moved U(-0.05, 0.05)
    rad, qvel 0, forward commands U(0.2, 0.6) m/s per env, `steps` env.steps
    with a replan every MPC_REPLAN (cold, then warm). Checks: every state
    finite, exactly 2 SPD and 1 Newton launch per env.step and none in a
    tick (counts set to 0 just before the loop, read just after), no host
    sync in a tick, and at least UPRIGHT_SHARE of the envs upright at the
    end (base z in [0.2, 0.35] m, R22 > 0.9). Prints mean vx against the
    command, closed-loop env-steps/s beside the bare env.step's in this
    call, the tick's host and device ms, and the replan-rate rule of
    tests/test_mpc_gate.py (phase 47's warm solves/s against the env's
    env-steps/s / 5). Keeps MPC_CPU_ENVS envs from step MPC_CPU_START."""
    env = QuadrupedEnv('go2', scene='flat', state_obs_names=('qpos', 'qvel'),
                       model=load_model('go2', 'flat', device=DEVICE))
    dm = env.model
    m = dm.m
    mpc = CentroidalMPC(dm, closed_loop_config())
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    qpos = torch.as_tensor(m.key_qpos[0], dtype=torch.float32, device=DEVICE).repeat(B, 1)
    qpos[:, 7:] += torch.rand(B, m.nq - 7, generator=gen, device=DEVICE) * 0.1 - 0.05
    ref = torch.zeros(B, 3, device=DEVICE)
    ref[:, 0] = torch.rand(B, generator=gen, device=DEVICE) * 0.4 + 0.2
    state, _ = env.reset(gen, B, qpos=qpos, qvel=torch.zeros(B, m.nv, device=DEVICE))
    finite = torch.ones((), dtype=torch.bool, device=DEVICE)
    vx = torch.zeros(B, device=DEVICE)
    warm, kept, per_step = None, {'taus': []}, []
    sync()
    spd.launches = nf.launches = 0
    t0 = time.perf_counter()
    for i in range(steps):
        if i % MPC_REPLAN == 0:
            if i == MPC_CPU_START:
                kept['state'] = state.map(lambda x: x[:MPC_CPU_ENVS].clone())
                kept['warm'] = tuple(w[:MPC_CPU_ENVS].clone() for w in warm)
            before = spd.launches, nf.launches
            tau, warm = mpc_tick(mpc, state, ref, warm)
            if (spd.launches, nf.launches) != before:
                raise AssertionError('an MPC tick launched a physics kernel')
            if MPC_CPU_START <= i < MPC_CPU_START + CPU_STEPS:
                kept['taus'].append(tau[:MPC_CPU_ENVS].clone())
        before = spd.launches, nf.launches
        state = env.step(state, tau)[0]
        per_step.append((spd.launches - before[0], nf.launches - before[1]))
        finite &= torch.isfinite(state.qpos).all() & torch.isfinite(state.qvel).all()
        if i >= steps // 2:
            vx += state.qvel[:, 0]
        if i + 1 == MPC_CPU_START + CPU_STEPS:
            kept['end'] = state.qpos[:MPC_CPU_ENVS].clone()
    sync()
    wall = time.perf_counter() - t0
    launches = {'spd_solve': spd.launches, 'newton_fused': nf.launches}
    rate = steps / wall
    vx = vx / (steps - steps // 2)
    z = state.qpos[:, 2]
    R22 = kinematics.quat_to_mat(state.qpos[:, 3:7])[:, 2, 2]
    upright = ((z >= 0.2) & (z <= 0.35) & (R22 > 0.9)).float().mean().item()

    tick = lambda: mpc_tick(mpc, state, ref, warm)
    syncs = sync_count(tick)
    tick_host = host_ms(tick)
    prof_host, tick_dev = range_ms(named(tick, 'mpc_tick'), 'mpc_tick')
    sync()
    t1 = time.perf_counter()
    bare = state
    for _ in range(20):
        bare = env.step(bare, tau)[0]
    sync()
    bare_rate = 20 / (time.perf_counter() - t1)
    log(phase, f'go2/flat env under the MPC, B={B} f32: {steps} env.steps and {steps // MPC_REPLAN} '
               f'solves in {wall:.3f} s = {rate:.3f} steps/s = {B * rate:.1f} env-steps/s; the '
               f'bare env.step with fixed torques in this call {bare_rate:.3f} steps/s = '
               f'{B * bare_rate:.1f} env-steps/s (closed loop / bare {rate / bare_rate:.3f}); '
               f'on {smi()}')
    log(phase, f'launches: spd_solve {launches["spd_solve"]}, newton_fused '
               f'{launches["newton_fused"]} (per env.step {sorted(set(per_step))}, none in a '
               f'tick); a warm tick: host {tick_host:.3f} ms (synchronised median), profiler '
               f'range host {prof_host or 0:.3f} ms, device '
               f'{"not measured" if tick_dev is None else f"{tick_dev:.3f} ms"}, host syncs '
               f'{syncs[0]}; on {smi()}')
    log(phase, f'after {steps} steps: upright {upright:.4f} of the envs (z in [0.2, 0.35] m and '
               f'R22 > 0.9), mean z {z.mean().item():.4f} m; mean vx over the last '
               f'{steps - steps // 2} steps {vx.mean().item():.4f} m/s against a mean command of '
               f'{ref[:, 0].mean().item():.4f} (mean |vx - command| '
               f'{(vx - ref[:, 0]).abs().mean().item():.4f})')
    log(phase, f'replan-rate rule (tests/test_mpc_gate.py): phase 47\'s warm {warm_rate:.1f} '
               f'solves/s against the bare env-steps/s / {MPC_REPLAN} = '
               f'{B * bare_rate / MPC_REPLAN:.1f} replans/s demanded: '
               f'{"met" if warm_rate >= B * bare_rate / MPC_REPLAN else "not met"} (printed, not '
               f'gated); on {smi()}')
    if not bool(finite):
        raise AssertionError('a state of the MPC closed loop is not finite')
    if any(k != (2, 1) for k in per_step):
        raise AssertionError(f'expected 2 spd_solve and 1 newton_fused launch per env.step, got '
                             f'{sorted(set(per_step))}')
    if syncs[0]:
        raise AssertionError(f'the MPC tick synchronises with the host: {syncs[1]}')
    if upright < UPRIGHT_SHARE:
        raise AssertionError(f'only {upright:.4f} of the envs upright after the closed loop')
    return {'env': env, 'mpc': mpc, 'ref': ref[:MPC_CPU_ENVS], 'kept': kept,
            'launches': launches}


def mpc_card_against_cpu(run, phase=49):
    """Phase 49: MPC_CPU_ENVS envs of phase 48's state at step
    MPC_CPU_START, its warm start and commands, stepped CPU_STEPS times with
    a replan every MPC_REPLAN through the same functions in f64 on the CPU:
    qpos within 1e-3 of the card's at the end; the torque gap per replan
    printed."""
    torch.set_num_threads(1)   # tiny batched products: one thread is fastest
    kept = run['kept']
    dm64 = load_model('go2', 'flat', device='cpu', dtype=torch.float64)
    env64 = QuadrupedEnv('go2', scene='flat', state_obs_names=('qpos', 'qvel'), model=dm64)
    mpc64 = CentroidalMPC(dm64, run['mpc'].cfg)
    state = kept['state'].to('cpu', torch.float64)
    warm = tuple(w.double().cpu() for w in kept['warm'])
    ref = run['ref'].double().cpu()
    taus = []
    for i in range(CPU_STEPS):
        if i % MPC_REPLAN == 0:
            tau, warm = mpc_tick(mpc64, state, ref, warm)
            taus.append(tau)
        state = env64.step(state, tau)[0]
    gaps = [(t64 - tc.double().cpu()).abs().max().item() for t64, tc in zip(taus, kept['taus'])]
    err = (kept['end'].double().cpu() - state.qpos).abs().max().item()
    log(phase, f'go2/flat under the MPC, {MPC_CPU_ENVS} envs, steps {MPC_CPU_START}..'
               f'{MPC_CPU_START + CPU_STEPS} ({len(taus)} replans): card f32 vs CPU f64 max '
               f'|qpos diff| {err:.3e}; torque gap per replan (N m) '
               f'{", ".join(f"{g:.3e}" for g in gaps)}')
    if not err < 1e-3:
        raise AssertionError(f'the MPC closed loop: card and CPU trajectories differ by {err}')


def eager_newton(M, a_s, efc, warmstart=None, iterations=10, ls_iterations=6,
                 iterations_out=None):
    """The eager f32 solve in place of the kernel's wrapper: the oracle."""
    return solver.solve(M, a_s, efc, warmstart, iterations, ls_iterations, iterations_out)


def mppi_kernel_steps(mppi, qpos, qvel, ctrls, phase):
    """Phase 50's check (1): the K rollouts of `ctrls` run again on the
    kernel, each of their H Newton solves kept; on each, the kernel against
    the eager f32 solve at the rollouts' cap (iteration counts and qacc per
    env), and, printed, the kernel at one iteration fewer and one more and
    the eager f64 solve against the same eager solve. Returns the bars
    failed."""
    cap = mppi.cfg.solver_iterations
    kernel = nf.solve_batched
    steps = []

    def record(M, a_s, efc, warmstart=None, iterations=10, **kw):
        steps.append((M, a_s, efc, warmstart))
        return kernel(M, a_s, efc, warmstart=warmstart, iterations=iterations, **kw)

    with mock.patch.object(nf, 'solve_batched', record):
        mppi._rollout_cost(qpos, qvel, ctrls)
    # per solve compared with the eager f32 one at the cap: envs whose
    # iteration count differs, per-env qacc gaps, mean iterations
    forms = [(f'the kernel at a cap of {c}', c) for c in (cap - 1, cap, cap + 1)]
    forms.append(('the eager f64 solve (at the f32 tolerance; what rounding alone does)', None))
    stats = {name: [0, [], 0.0] for name, _ in forms}
    tol = solver._TOL[torch.float32]
    for M, a_s, efc, w in steps:
        it_e = torch.zeros(a_s.shape[0], dtype=torch.int32, device=a_s.device)
        ref = solver.solve(M, a_s, efc, w, cap, iterations_out=it_e)[0]
        for name, c in forms:
            it = torch.zeros_like(it_e)
            if c is None:   # the SPD kernel takes f32 only: the f64 solve's SPD solves run plain
                with mock.patch.object(solver, 'spd_solve_batched', spd.unrolled_chol_solve_torch):
                    got = solver.solve(M.double(), a_s.double(), as_f64(efc),
                                       None if w is None else w.double(), cap,
                                       iterations_out=it, _tol=tol)[0]
            else:
                got = kernel(M, a_s, efc, warmstart=w, iterations=c, iterations_out=it)[0]
            st = stats[name]
            st[0] += int((it != it_e).sum())
            st[1].append(((got.double() - ref.double()).abs().amax(-1)
                          / (1 + ref.double().abs().amax(-1))))
            st[2] += it.float().mean().item() / len(steps)
    n = len(steps) * steps[0][1].shape[0]
    read = {}
    for name, c in forms:
        n_it, gaps, mean_it = stats[name]
        g = torch.cat(gaps)
        read[c] = (n_it / n, g.median().item())
        log(phase, f'the {len(steps)} Newton solves of the {ctrls.shape[0]} rollouts ({n} '
                   f'env-steps), {name} against the eager f32 solve at {cap}: iteration counts '
                   f'differ in {n_it} ({read[c][0]:.4f}), qacc per env (of 1 + max|qacc|) '
                   f'median {read[c][1]:.3e}, p99 {g.quantile(0.99).item():.3e}, max '
                   f'{g.max().item():.3e}, share above {NEWTON_BAR} '
                   f'{(g > NEWTON_BAR).double().mean().item():.4f}; mean iterations '
                   f'{mean_it:.3f}' + ('' if c in (cap, None) else
                                       ' (what a kernel stopping one iteration off reads)'))
    failures = []
    if not read[cap][0] <= ITERATION_ENVS_BAR:
        failures.append(f'MPPI cap {cap}: iteration counts differ in {read[cap][0]:.4f} of the '
                        f'env-steps (bar {ITERATION_ENVS_BAR})')
    if not read[cap][1] <= MPPI_STEP_MEDIAN_BAR:
        failures.append(f'MPPI cap {cap}: the median env\'s qacc gap {read[cap][1]:.3e} (bar '
                        f'{MPPI_STEP_MEDIAN_BAR})')
    return failures


def mppi_rollout_agreement(mppi, qpos, qvel, ctrls, phase):
    """Phase 50's check (2): the rollouts of `ctrls` (8) on the card through
    the kernel and through the eager f32 solve at the rollouts' cap (the
    eager one at one iteration fewer and one more printed beside it), and
    in f64 on the CPU at that cap (printed) and at a cap of 30, where the
    solves converge (MPPI_COST_BAR; in a CPU worker, checked when done).
    Returns the bars failed on the card."""
    torch.set_num_threads(1)   # tiny batched products: one thread is fastest
    dm, cfg = mppi.model, mppi.cfg
    cap = cfg.solver_iterations
    at = lambda model, cost, c: MPPI(model, cost, dataclasses.replace(cfg, solver_iterations=c))
    rel = lambda x, ref: ((x - ref).abs() / ref.abs()).max().item()
    kernel = at(dm, mppi.cost_fn, cap)._rollout_cost(qpos, qvel, ctrls).double().cpu()
    card30 = at(dm, mppi.cost_fn, GO2_AGREEMENT_ITERATIONS)._rollout_cost(
        qpos, qvel, ctrls).double().cpu()
    with mock.patch.object(nf, 'solve_batched', eager_newton):
        eager = {c: at(dm, mppi.cost_fn, c)._rollout_cost(qpos, qvel, ctrls).double().cpu()
                 for c in (cap - 1, cap, cap + 1)}
    k_e = rel(kernel, eager[cap])
    gap = (kernel - eager[cap]).abs().max().item()
    log(phase, f'{len(ctrls)} rollouts at a Newton cap of {cap}, costs through the kernel '
               f'{", ".join(f"{x:.4f}" for x in kernel.tolist())}; through the eager f32 solve '
               f'max relative gap {k_e:.3e}, absolute {gap:.3e} (a weight exp(-cost / lambda) '
               f'moves by a factor of at most exp({gap / cfg.temperature:.3e})), bar '
               f'{MPPI_CAP4_COST_BAR}; the eager f32 solve at caps {cap - 1} and {cap + 1} '
               f'against it at {cap}: {rel(eager[cap - 1], eager[cap]):.3e} and '
               f'{rel(eager[cap + 1], eager[cap]):.3e} (what a kernel stopping one iteration '
               f'off reads)')

    def finish(f64):
        c30 = rel(card30, f64[GO2_AGREEMENT_ITERATIONS])
        log(phase, f'against f64 on the CPU: at a cap of {GO2_AGREEMENT_ITERATIONS} (converged) '
                   f'card f32 {c30:.3e} (bar {MPPI_COST_BAR}); at {cap} (printed) the kernel '
                   f'{rel(kernel, f64[cap]):.3e}, the eager f32 solve '
                   f'{rel(eager[cap], f64[cap]):.3e}; f64 at {cap} against f64 at '
                   f'{GO2_AGREEMENT_ITERATIONS} {rel(f64[cap], f64[GO2_AGREEMENT_ITERATIONS]):.3e}',
            late=True)
        if not c30 <= MPPI_COST_BAR:
            raise AssertionError(f'MPPI rollout costs at a cap of {GO2_AGREEMENT_ITERATIONS}: '
                                 f'card and f64 CPU differ by {c30:.3e}')

    later(cpu_mppi_costs, (cfg, (cap, GO2_AGREEMENT_ITERATIONS), qpos.double().cpu(),
                           qvel.double().cpu(), ctrls.double().cpu()), finish)

    failures = []
    if not k_e <= MPPI_CAP4_COST_BAR:
        failures.append(f'MPPI rollout costs at a cap of {cap}: kernel and eager f32 differ by '
                        f'{k_e:.3e}')
    return failures


def mppi_solves(phase=50, K=None):
    """Phase 50: MPPI on go2/flat at the reference's defaults (K=1024,
    H=24, sigma 2, lambda 1, a Newton cap of 4) with velocity_tracking_cost
    at a forward command of 0.4 m/s, from the keyframe: two solves, the
    second from shift(u1). Prints seconds per solve, rollouts/s, launches
    per solve (H Newton, 2 H SPD), peak memory. Checks: each updated plan's
    cost within 1.05 of its nominal's (tests/test_mppi.py), 1 <= ess <= K;
    the first solve's K rollouts again, the kernel against the eager f32
    solve on each of their Newton solves (`mppi_kernel_steps`); 8 of them
    through the kernel, the eager f32 solve and in f64 on the CPU
    (`mppi_rollout_agreement`). Prints the four plans' costs at a cap of 30
    beside the cap of 4's."""
    dm = load_model('go2', 'flat', device=DEVICE)
    m = dm.m
    cfg = MPPIConfig() if K is None else MPPIConfig(n_samples=K)
    height = float(m.key_qpos[0][2])
    mppi = MPPI(dm, velocity_tracking_cost(dm, (0.4, 0.0, 0.0), 0.0, height), cfg)
    qpos = torch.as_tensor(m.key_qpos[0], dtype=torch.float32, device=DEVICE)
    qvel = torch.zeros(m.nv, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    u0 = torch.zeros(cfg.horizon, m.nu, device=DEVICE)
    draws = gen.get_state()
    plans, infos, secs, launches = [u0], [], [], []
    sync()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        nominal = plans[-1] if len(plans) == 1 else MPPI.shift(plans[-1])
        spd.launches = nf.launches = 0
        t0 = time.perf_counter()
        u, info = mppi.solve(gen, qpos, qvel, nominal)
        sync()
        secs.append(time.perf_counter() - t0)
        launches.append((spd.launches, nf.launches))
        plans += [nominal, u]
        infos.append(info)
    peak = torch.cuda.max_memory_allocated() / 2**30
    costs = mppi._rollout_cost(qpos, qvel, torch.stack(plans[1:]))   # u0, u1, shift(u1), u2
    c = costs.tolist()
    log(phase, f'go2/flat MPPI K={cfg.n_samples} H={cfg.horizon} cap {cfg.solver_iterations}: '
               f'{secs[0]:.3f} s and {secs[1]:.3f} s per solve = '
               f'{cfg.n_samples / secs[1]:.1f} rollouts/s ({cfg.n_samples * cfg.horizon / secs[1]:.1f} '
               f'rollout steps/s); launches per solve (spd_solve, newton_fused) {launches}; peak '
               f'device memory {peak:.3f} GiB; on {smi()}')
    log(phase, f'costs: nominal {c[0]:.4f} -> updated {c[1]:.4f} (ess {infos[0]["ess"].item():.2f}, '
               f'best sample {infos[0]["best_cost"].item():.4f}); shifted {c[2]:.4f} -> updated '
               f'{c[3]:.4f} (ess {infos[1]["ess"].item():.2f}, best sample '
               f'{infos[1]["best_cost"].item():.4f})')
    failures = []
    for (before, after), info in zip(((c[0], c[1]), (c[2], c[3])), infos):
        if not (np.isfinite(after) and after <= before * 1.05):
            failures.append(f'MPPI: the updated plan costs {after} against {before}')
        if not 1.0 <= info['ess'].item() <= cfg.n_samples:
            failures.append(f'MPPI: ess {info["ess"].item()} outside [1, K]')
    if launches[0] != (2 * cfg.horizon, cfg.horizon):
        failures.append(f'MPPI: expected {2 * cfg.horizon} spd_solve and {cfg.horizon} '
                        f'newton_fused launches per solve, got {launches[0]}')

    # the first solve's K control sequences, drawn again from its generator state
    gen.set_state(draws)
    eps = cfg.sigma * torch.randn((cfg.n_samples, cfg.horizon, m.nu), generator=gen,
                                  device=DEVICE)
    ctrls = u0[None] + eps
    failures += mppi_kernel_steps(mppi, qpos, qvel, ctrls, phase)
    failures += mppi_rollout_agreement(mppi, qpos, qvel, ctrls[:8], phase)

    # the four plans at a Newton cap where the solves converge, beside the cap's
    capped = dataclasses.replace(cfg, solver_iterations=GO2_AGREEMENT_ITERATIONS)
    c30 = MPPI(dm, mppi.cost_fn, capped)._rollout_cost(qpos, qvel, torch.stack(plans[1:])).tolist()
    log(phase, f'the four plans (nominal, updated, shifted, updated) at a Newton cap of '
               f'{cfg.solver_iterations}: {", ".join(f"{x:.4f}" for x in c)} (updated / nominal '
               f'{c[1] / c[0]:.4f}, {c[3] / c[2]:.4f}); at a cap of {GO2_AGREEMENT_ITERATIONS}: '
               f'{", ".join(f"{x:.4f}" for x in c30)} (updated / nominal {c30[1] / c30[0]:.4f}, '
               f'{c30[3] / c30[2]:.4f}; printed: the rule is held at the rollouts\' cap)')
    if failures:
        raise AssertionError('; '.join(failures))
    return {'spd_solve': sum(x[0] for x in launches), 'newton_fused': sum(x[1] for x in launches)}


def mpc_phases(spd_fields, newton_fields):
    """Phases 47-50: MPC solves/s at H=12 and B=4096, the go2/flat closed
    loop, its card against CPU window, MPPI."""
    warm_rate = mpc_solves()
    run = mpc_closed_loop(warm_rate)
    mpc_card_against_cpu(run)
    spd_fields['mpc_env_launches'] = run['launches']['spd_solve']
    newton_fields['mpc_env_launches'] = run['launches']['newton_fused']
    del run
    launches = mppi_solves()
    spd_fields['mppi_launches'] = launches['spd_solve']
    newton_fields['mppi_launches'] = launches['newton_fused']


# ---- phases 51-67: the per-slot contact rows and the mesh colliders ---------------------

# go1 (its 419 condim-1 slots as one row each beside 32 culled cone blocks:
# ns 443), mini_cheetah (pyramidal, condims 1 and 3, unculled: ns 402, the
# mesh groups) and hyqreal1 (elliptic, the mesh groups), each through
# `scene_phases`: the agreement of `go2_agreement` (three solves at caps 10
# and 30, then phase 5's checks at 30), 21, 5 and 31 steps (the mesh
# robots take ~1 s per step at B=4096), the card against the CPU's f64 at a
# Newton cap of 30 (go1's f32 solve may stop unconverged at 10, as go2's
# does), the Newton timing and the profile (1 step) with the narrow phase by
# group. The mesh robots step 4 envs on the CPU: its f64 mesh groups take
# seconds per step. hyqreal1's feet start above the floor: its comparison
# covers steps 30-50; it and mini_cheetah's window run past their main
# paths on the card (`card_continued`).
MESH_CPU_ENVS = 4
ROBOT_CPU_CAP = 30
ROBOT_SCENES = (
    (51, 'go1', 'flat', 21, (0,), N_CPU_ENVS, None, 'go1_'),
    (56, 'mini_cheetah', 'flat', 5, (0,), MESH_CPU_ENVS, None, 'mini_cheetah_'),
    (61, 'hyqreal1', 'flat', 31, (30,), MESH_CPU_ENVS, None, 'hyqreal1_'),
)
# phase 67's steps per perlin scene, and phase 66's env.steps at B=1 and
# B=4096: the mesh scenes take 1-4 s per step at B=4096 (PERF.md)
ROBOT_PERLIN_STEPS = {'go1': 3, 'hyqreal1': 2, 'mini_cheetah': 2}
CFG1_STEPS = {1: 10, BATCH: 3}


def robot_agreement(dm, phase):
    """Phases 51, 56 and 61: `go2_agreement` on the robot's soft states
    (mini_cheetah has no cone blocks to require); for ROUNDING_ROBOTS with
    `rounding_bars` in both of its parts."""
    if dm.m.robot not in ROUNDING_ROBOTS:
        return go2_agreement(dm, phase, dims_needed=())
    M, a_s, efc = soft_state(dm, torch.Generator(device='cuda').manual_seed(SEED), BATCH)
    failures, _ = three_solves(dm, M, a_s, efc, f'{dm.m.robot}/{dm.m.scene} soft states',
                               phase, (10, GO2_AGREEMENT_ITERATIONS), None, rounding=True)
    abs_err, more, _ = newton_agreement(dm, phase, GO2_AGREEMENT_ITERATIONS,
                                        GO2_ITERATION_ENVS_BAR, rounding=True, limits=False)
    return abs_err, failures + more


def cfg1_env(rates, phase=66, steps=CFG1_STEPS):
    """Phase 66: BASELINE cfg1, `QuadrupedEnv('mini_cheetah', scene='flat')`
    with a forward command and random actions, steps[B] env.steps at B=1
    (cfg1's single env) and at B=4096, each beside the bare step's rate in
    this call (phase 57's at B=4096; at B=1 as many bare steps from the
    keyframe), with `env_main_path`'s checks: launches per step, host
    synchronisations, every state finite."""
    dm = load_model('mini_cheetah', 'flat', device='cuda', dtype=torch.float32)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 1)
    qpos = start_qpos(dm)[0][None]
    qvel = torch.zeros(1, dm.m.nv, device='cuda')
    ctrls = torch.rand(steps[1], 1, dm.m.nu, generator=gen, device='cuda') * 4.0 - 2.0
    warm = torch.zeros_like(qvel)
    engine.step_batched(dm, qpos, qvel, ctrls[0], warmstart=warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps[1]):
        qpos, qvel, fwd = engine.step_batched(dm, qpos, qvel, ctrls[t], warmstart=warm)
        warm = fwd.qacc
    torch.cuda.synchronize()
    bare_1 = steps[1] / (time.perf_counter() - t0)
    log(phase, f'mini_cheetah/flat bare step_batched B=1 f32: {bare_1:.2f} steps/s on {smi()}')
    out = {}
    for B, bare in ((1, bare_1), (BATCH, rates['mini_cheetah', 'flat'])):
        run = env_main_path(bare, phase, 'flat', 'forward', steps[B],
                            57 if B == BATCH else phase, robot='mini_cheetah', B=B)
        out[B] = run['launches']
        del run
    return out


def robot_terrain_steps(phase=67, steps=ROBOT_PERLIN_STEPS):
    """Phase 67: go1/perlin, hyqreal1/perlin and mini_cheetah/perlin (ns
    1,058, one env per block) at B=4096, steps[robot] steps of
    `step_batched` each from the start on the terrain (phase 36's checks), the last step's
    Newton kernel against the eager f32 solve (`newton_timing`), then each
    narrow-phase group's stream and host ms (the heightfield-mesh group's
    among them). Returns {robot: (launches, Newton timings)}."""
    out = {}
    for robot in ('go1', 'hyqreal1', 'mini_cheetah'):
        dm = load_model(robot, 'perlin', device='cuda', dtype=torch.float32)
        log_start(dm, phase)
        run = main_path(dm, phase, steps[robot], (), 0)
        newton = newton_timing(run['last'], phase, robot in ROUNDING_ROBOTS)
        narrow_phase_groups(dm, run, phase)
        out[robot] = run['launches'], newton
        del run
    return out


def robot_phases(spd_fields, newton_fields, rates):
    """Phases 51-67: go1/flat, mini_cheetah/flat and hyqreal1/flat's five
    phases each, BASELINE cfg1's env (66), the three perlin scenes (67)."""
    for entry in ROBOT_SCENES:
        entry = entry[:6] + (robot_agreement,) + entry[7:]
        rates[entry[1:3]] = scene_phases(entry, spd_fields, newton_fields, ROBOT_CPU_CAP, 1)
    for B, launches in cfg1_env(rates).items():
        key = 'cfg1_env_b1_launches' if B == 1 else 'cfg1_env_launches'
        spd_fields[key] = launches['spd_solve']
        newton_fields[key] = launches['newton_fused']
    for robot, (launches, newton) in robot_terrain_steps().items():
        spd_fields[f'{robot}_perlin_launches'] = launches['spd_solve']
        newton_fields.update({f'{robot}_perlin_launches': launches['newton_fused'],
                              **{f'{robot}_perlin_{k}': v for k, v in newton.items()}})


# ---- phases 68-73: the mixed-robot batch (BASELINE cfg5) --------------------------------

# bench.py's cfg5 recipe (`measure_mixed_camera`): go2, aliengo and mini_cheetah
# on flat in the shares 1/2, 1/4, 1/4 of the batch, three observables, seeded
# U(-2, 2) torques, a 16 x 16 depth camera on aliengo's robotcam shot on the
# aliengo group's qpos every 16 steps (30 fps at dt = 0.002) through
# `rollout_with_sensors`, 3 chunks of 16 steps
CFG5_ROBOTS = ('go2', 'aliengo', 'mini_cheetah')
CFG5_OBS = ('qpos', 'qvel', 'contact_state')
CFG5_CAMERA = {'width': 16, 'height': 16, 'cam_name': 'robotcam'}
CFG5_CHUNK = 16
CFG5_CHUNKS = 3
# each group alone at its own batch (phase 68), for its own rate
CFG5_GROUP_STEPS = 4
# phase 70: envs of each group from the state after chunk 2, stepped CPU_STEPS times
CFG5_CPU_ENVS = 4
# phase 72: the read-back's windows and the batch drawn
CFG5_X_FRAMES, CFG5_Y_FRAMES = 5, 1
CFG5_READ_BATCH = 1024
# checkpoints, recordings and the trace of phases 68-73 (build/ is not committed)
CFG5_DIR = 'build/cfg5'


def cfg5_env(B, **kw):
    """BASELINE cfg5's mixed env of B envs (go2 B/2, aliengo B/4, mini_cheetah
    B/4) on DEVICE in f32, a forward command of 0.5 m/s (the env's default)."""
    counts = (B // 2, B // 4, B - B // 2 - B // 4)
    return MixedQuadrupedEnv(
        [(r, c, {'model': load_model(r, 'flat', device=DEVICE, dtype=torch.float32)})
         for r, c in zip(CFG5_ROBOTS, counts)], scene='flat', state_obs_names=CFG5_OBS, **kw)


def group_rows(env):
    """Each group's rows of the mixed batch."""
    ends = np.cumsum([0] + env.counts)
    return [slice(int(a), int(b)) for a, b in zip(ends[:-1], ends[1:])]


def state_gap(a, b):
    """(bitwise equal, max |difference|) over every tensor of two states."""
    la, lb = leaves_with_path(a), leaves_with_path(b)
    if [k for k, _ in la] != [k for k, _ in lb]:
        raise AssertionError('the two states differ in structure')
    equal = all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    gap = max((x.double() - y.double()).abs().max().item() for (_, x), (_, y) in zip(la, lb))
    return equal, gap


def nondeterministic_ops(fn):
    """The first lines of PyTorch's warnings about operations it does not
    run repeatably, raised while fn() runs under
    `torch.use_deterministic_algorithms(True, warn_only=True)`."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            fn()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).splitlines()[0][:200] for w in caught})


def upright_share(state):
    """Share of envs whose base z axis is within 26 degrees of vertical."""
    q = state.qpos[:, 3:7]
    R22 = 1 - 2 * (q[:, 1] ** 2 + q[:, 2] ** 2)
    return (R22 > 0.9).float().mean().item()


def cfg5_main_path(phase=68, B=BATCH):
    """Phase 68: BASELINE cfg5, B envs in three robot groups through
    `MixedQuadrupedEnv`: a random reset, then 3 chunks of 16 `env.step`
    through `rollout_with_sensors` with the aliengo camera shot after each
    chunk, one `RateMeter` lap per chunk (each chunk's torques drawn from the
    generator before it). The launch counts are set to 0 just before the
    chunks and read just after (exactly 2 SPD and 1 Newton launch per group
    per step), host syncs of one mixed step (0), every group finite and
    upright, peak memory; each group's own rate alone at its batch
    (CFG5_GROUP_STEPS steps in this call). After chunk 1 the state tuple,
    the generator's state and the camera's readout are checkpointed (phase
    71). On the last step each group's Newton kernel is held against the
    eager f32 solve (`newton_timing`) and the SPD kernel against its plain
    version, on the inputs the step gave them."""
    env = cfg5_env(B)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state0, _ = env.reset(gen)
    sync()
    log(phase, f'cfg5 {"+".join(f"{e.robot_name} {c}" for e, c in zip(env.groups, env.counts))}'
               f' = {env.batch_size} envs, obs {env.obs_names} (dims '
               f'{[env._obs_dims[n] for n in env.obs_names]}): reset {time.perf_counter() - t0:.3f}'
               f' s, lift rounds {[e.lift_rounds for e in env.groups]}; on {smi()}')
    cam = Camera(env.groups[1].model, **CFG5_CAMERA)
    meter = RateMeter('env steps')
    obs_seq, time_seq, action_seq, per_step, last = [], [], [], [], {}

    def step(s, a):
        before = spd.launches, nf.launches
        if len(per_step) == CFG5_CHUNK * CFG5_CHUNKS - 1:   # the last step: keep its inputs
            out, last['spd'], last['newton'] = kept_kernel_inputs(lambda: env.step(s, a, gen))
        else:
            out = env.step(s, a, gen)
        per_step.append((spd.launches - before[0], nf.launches - before[1]))
        obs_seq.append(out[1])
        time_seq.append(torch.cat([g.time for g in out[0]]))
        action_seq.append(a)
        return out

    def shoot(s):
        return cam.shoot(s[1].qpos)[0]

    state, states, readouts, actions = state0, {0: state0}, [], []
    finite = torch.ones((), dtype=torch.bool, device=DEVICE)
    out_dir = Path(CFG5_DIR)
    sync()
    spd.launches = nf.launches = 0
    for k in range(CFG5_CHUNKS):
        acts = torch.rand(CFG5_CHUNK, B, env.nu_max, generator=gen, device=DEVICE) * 4.0 - 2.0
        with meter.lap(B * CFG5_CHUNK):
            state, depth = rollout_with_sensors(step, state, acts, shoot, CFG5_CHUNK)
            meter.sync((state, depth))
        actions.append(acts)
        readouts.append(depth)
        states[CFG5_CHUNK * (k + 1)] = state
        for s in state:
            finite &= all_finite(s, {})
        if k == 0:   # outside the laps: the checkpoint that phase 71 resumes from
            t1 = time.perf_counter()
            checkpoint.save(out_dir / 'chunk1.npz', state, gen)
            checkpoint.save(out_dir / 'chunk1_camera.npz', depth)
            saved = {'gen': gen.get_state(), 'seconds': time.perf_counter() - t1}
    launches = {'spd_solve': spd.launches, 'newton_fused': nf.launches}
    laps = ', '.join(f'{n / dt:.1f}' for n, dt in meter.laps())
    log(phase, f'cfg5 B={B} f32: {CFG5_CHUNKS} chunks of {CFG5_CHUNK} env.steps with the camera '
               f'after each: {meter.rate():.1f} env-steps/s (RateMeter median of the chunks: '
               f'{laps}) = {meter.rate() / B:.3f} steps/s; peak device memory from the reset on '
               f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; on {smi()}')
    log(phase, f'launches: spd_solve {launches["spd_solve"]}, newton_fused '
               f'{launches["newton_fused"]} (per step {sorted(set(per_step))}); checkpoint after '
               f'chunk 1 written in {saved["seconds"]:.3f} s; camera depth of the last shot in '
               f'[{readouts[-1].min().item():.4f}, {readouts[-1].max().item():.4f}] m')
    if not bool(finite) or not all(bool(torch.isfinite(d).all()) for d in readouts):
        raise AssertionError('a cfg5 state or camera readout is not finite')
    G = len(env.groups)
    if any(k != (2 * G, G) for k in per_step):
        raise AssertionError(f'expected {2 * G} spd_solve and {G} newton_fused launches per '
                             f'cfg5 step, got {sorted(set(per_step))}')
    shares = {e.robot_name: upright_share(s) for e, s in zip(env.groups, state)}
    heights = ', '.join(f'{e.robot_name} {s.qpos[:, 2].mean().item():.4f}'
                        for e, s in zip(env.groups, state))
    log(phase, 'upright share per group ' + ', '.join(f'{r} {v:.4f}' for r, v in shares.items())
               + f', mean base height {heights}')
    if min(shares.values()) < UPRIGHT_SHARE:
        raise AssertionError(f'a cfg5 group is not upright: {shares}')
    syncs = sync_count(lambda: env.step(state, actions[-1][-1], gen))
    log(phase, f'host synchronisations reported in one mixed env.step: {syncs[0]} '
               f'(first: {syncs[1]})')
    if syncs[0] != 0:
        raise AssertionError(f'a cfg5 step syncs with the host {syncs[0]} times: {syncs[1]}')

    # each group alone at its own batch, from its slice of the last state
    alone = {}
    for g, (e, rows) in enumerate(zip(env.groups, group_rows(env))):
        s, a = state[g], actions[-1][-1][rows, :e.model.m.nu]
        solo = RateMeter('env steps')
        e.step(s, a)
        sync()
        with solo.lap(s.qpos.shape[0] * CFG5_GROUP_STEPS):
            for _ in range(CFG5_GROUP_STEPS):
                s = e.step(s, a)[0]
            solo.sync(s)
        alone[e.robot_name] = solo.rate()
    combined = B / sum(c / alone[e.robot_name] for e, c in zip(env.groups, env.counts))
    log(phase, 'each group alone at its batch (' + ', '.join(
        f'{e.robot_name} {c}: {alone[e.robot_name]:.1f} env-steps/s'
        for e, c in zip(env.groups, env.counts)) + f'); their times added give '
        f'{combined:.1f} env-steps/s for B={B}, the mixed batch {meter.rate():.1f} '
        f'({meter.rate() / combined:.3f} of it); on {smi()}')

    # the last step's kernels on the inputs it gave them
    fields = {'spd': {}, 'newton': {}}
    for e, (A, b), newton_in in zip(env.groups, last['spd'][::2], last['newton']):
        x = spd.spd_solve_batched(A, b)
        sync()
        err = rel_err(x, spd.unrolled_chol_solve_torch(A, b))
        log(phase, f'{e.robot_name} last step: SPD kernel vs plain on its smooth solve '
                   f'(B={A.shape[0]}, n={A.shape[1]}) rel err {err:.3e}')
        if not err < 1e-4:
            raise AssertionError(f'SPD kernel off its plain version by {err} on {e.robot_name}')
        fields['spd'][f'cfg5_{e.robot_name}_last_step_rel_err'] = err
        newton = newton_timing(newton_in, phase, e.robot_name in ROUNDING_ROBOTS)
        fields['newton'].update({f'cfg5_{e.robot_name}_{k}': v for k, v in newton.items()})
    return {'env': env, 'gen': gen, 'state0': state0, 'states': states, 'actions': actions,
            'readouts': readouts, 'launches': launches, 'saved': saved, 'fields': fields,
            'obs': obs_seq, 'time': time_seq, 'action': action_seq, 'rate': meter.rate()}


def cfg5_repeat_rule(run, phase):
    """The bar of phases 69 and 71: 0 (bitwise) when two runs of chunk 1's
    steps from the reset state agree bit for bit on this device, else the
    gap between them, with the operations PyTorch names as not repeatable."""
    env, state = run['env'], run['state0']
    for a in run['actions'][0]:
        state = env.step(state, a)[0]
    equal, gap = state_gap(state, run['states'][CFG5_CHUNK])
    log(phase, f'two runs of the {CFG5_CHUNK} steps of chunk 1 from the reset state: bitwise '
               f'equal {equal}, max |difference| {gap:.3e}')
    if equal:
        return 0.0
    s0, a0 = run['state0'], run['actions'][0][0]
    ops = nondeterministic_ops(lambda: env.step(s0, a0))
    log(phase, f'operations PyTorch runs non-repeatably in a cfg5 step: {ops or "none named"}; '
               f'the comparisons below are held to the gap {gap:.3e}')
    return gap


def cfg5_against_homogeneous(run, phase=69):
    """Phase 69: each group of the mixed batch against that group's own
    homogeneous env (a `QuadrupedEnv` of its robot alone, at its batch) over
    chunk 1's steps from the reset state: bit for bit, or within the
    run-to-run gap (`cfg5_repeat_rule`). Returns the rule's bar."""
    bar = cfg5_repeat_rule(run, phase)
    env, want = run['env'], run['states'][CFG5_CHUNK]
    for g, (e, rows) in enumerate(zip(env.groups, group_rows(env))):
        alone = QuadrupedEnv(e.robot_name, scene='flat', state_obs_names=CFG5_OBS, model=e.model)
        s = run['state0'][g]
        for a in run['actions'][0]:
            s = alone.step(s, a[rows, :e.model.m.nu])[0]
        equal, gap = state_gap(s, want[g])
        log(phase, f'{e.robot_name} ({rows.stop - rows.start} envs): mixed batch vs its '
                   f'homogeneous env after {CFG5_CHUNK} steps: bitwise equal {equal}, max '
                   f'|difference| {gap:.3e} (bar {bar:.3e})')
        if not (equal or gap <= bar):
            raise AssertionError(f'{e.robot_name}: the mixed batch parts from its homogeneous '
                                 f'env by {gap}')
    return bar


def cfg5_card_against_cpu(run, phase=70, n=CFG5_CPU_ENVS, cap=ROBOT_CPU_CAP):
    """Phase 70: the first n envs of each group from the state after chunk 2,
    moved along the floor to the origin (f32 resolves 0.5-1 mm where the
    flat scenes spawn, up to 10 km out), stepped CPU_STEPS times at a Newton
    cap of `cap` through a mixed env of n envs per group on the card in f32
    and on the CPU in f64, with seeded U(-2, 2) torques: every env's qpos
    within 1e-3."""
    torch.set_num_threads(1)
    env = run['env']
    start = []
    for s in run['states'][2 * CFG5_CHUNK]:
        s = s.map(lambda x: x[:n].clone())
        s.qpos[:, :2] = 0.0
        start.append(s)
    kw = dict(state_obs_names=CFG5_OBS, solver_iterations=cap)
    card = MixedQuadrupedEnv([(e.robot_name, n, {'model': e.model}) for e in env.groups],
                             scene='flat', **kw)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + phase)
    actions = torch.rand(CPU_STEPS, card.batch_size, card.nu_max, generator=gen,
                         device=DEVICE) * 4.0 - 2.0
    s_card = tuple(start)
    t0 = time.perf_counter()
    for a in actions:
        s_card = card.step(s_card, a)[0]
    card_s = time.perf_counter() - t0

    def finish(s_cpu):
        errs = {e.robot_name: (c.qpos.double().cpu() - f.qpos).abs().max().item()
                for e, c, f in zip(env.groups, s_card, s_cpu)}
        log(phase, f'{n} envs of each group, steps {2 * CFG5_CHUNK}..'
                   f'{2 * CFG5_CHUNK + CPU_STEPS} at a Newton cap of {cap}, card f32 vs CPU f64 '
                   f'max |qpos diff|: ' + ', '.join(f'{r} {v:.3e}' for r, v in errs.items())
                   + f' (the card\'s steps {card_s:.1f} s)', late=True)
        if not max(errs.values()) < 1e-3:
            raise AssertionError(f'cfg5: card and CPU trajectories differ: {errs}')

    later(cpu_mixed_steps, ([(e.robot_name, n) for e in env.groups], kw,
                            tuple(s.to('cpu', torch.float64) for s in start),
                            actions.double().cpu()), finish)


def cfg5_resume(run, bar, phase=71, B=BATCH):
    """Phase 71: the checkpoint written after chunk 1 restored into a freshly
    built mixed env with a fresh generator: every tensor, the generator's
    state and the camera readout bit for bit as saved; then chunk 2 again
    from it (its torques drawn from the restored generator), the state
    after it and its camera readout held to phase 69's rule."""
    out_dir = Path(CFG5_DIR)
    env = cfg5_env(B)
    gen = torch.Generator(device=DEVICE)
    t0 = time.perf_counter()
    state = checkpoint.restore(out_dir / 'chunk1.npz', run['states'][0], gen)
    depth = checkpoint.restore(out_dir / 'chunk1_camera.npz', run['readouts'][0])
    restore_s = time.perf_counter() - t0
    equal, gap = state_gap(state, run['states'][CFG5_CHUNK])
    same_gen = torch.equal(gen.get_state(), run['saved']['gen'])
    size = (out_dir / 'chunk1.npz').stat().st_size / 2**20
    log(phase, f'restored in {restore_s:.3f} s ({size:.2f} MiB): state bitwise equal {equal} '
               f'(max |difference| {gap:.3e}), generator state equal {same_gen}, camera readout '
               f'equal {torch.equal(depth, run["readouts"][0])}')
    if not (equal and same_gen and torch.equal(depth, run['readouts'][0])):
        raise AssertionError('the restored checkpoint differs from what was saved')
    cam = Camera(env.groups[1].model, **CFG5_CAMERA)
    acts = torch.rand(CFG5_CHUNK, B, env.nu_max, generator=gen, device=DEVICE) * 4.0 - 2.0
    state, readout = rollout_with_sensors(lambda s, a: env.step(s, a, gen), state, acts,
                                          lambda s: cam.shoot(s[1].qpos)[0], CFG5_CHUNK)
    if not torch.equal(acts, run['actions'][1]):
        raise AssertionError('the restored generator drew other torques for chunk 2')
    equal, gap = state_gap(state, run['states'][2 * CFG5_CHUNK])
    cam_gap = (readout - run['readouts'][1]).abs().max().item()
    log(phase, f'resumed chunk 2 against the uninterrupted run: state bitwise '
               f'equal {equal}, max |difference| {gap:.3e}; camera readouts max |difference| '
               f'{cam_gap:.3e} (bar {bar:.3e})')
    if not (equal or gap <= bar) or (bar == 0 and cam_gap != 0):
        raise AssertionError(f'the resumed run parts from the uninterrupted one by {gap}, its '
                             f'camera by {cam_gap}')


def cfg5_record(run, phase=72):
    """Phase 72: the 48 steps of each group written to one H5 file per group
    with `H5Writer.append_batch` (an episode per env: the observables, the
    time and the torques), then read back with `H5Reader` and
    `ProprioceptiveDataset` (x_frames 5, y_frames 1, loaded to DEVICE): one
    batch drawn with `as_batches` equals the in-memory observations
    exactly (f32 values stored as float64). Left out alone where h5py is
    not installed on this machine."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        log(phase, 'h5py is not installed on this machine: the record and read-back check is '
                   'left out')
        return
    env = run['env']
    obs = {n: torch.stack([o[n] for o in run['obs']], 1) for n in CFG5_OBS}   # (B, T, d)
    times = torch.stack(run['time'], 1)
    acts = torch.stack(run['action'], 1)
    T = times.shape[1]
    out_dir = Path(CFG5_DIR)
    for e, rows in zip(env.groups, group_rows(env)):
        path = out_dir / f'{e.robot_name}.h5'
        dims = e.observation_space_dims()
        t0 = time.perf_counter()
        H5Writer(path, env=e).append_batch(
            {**{n: obs[n][rows, :, :dims[n]] for n in CFG5_OBS},
             'action': acts[rows, :, :e.model.m.nu]}, times[rows])
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        reader = H5Reader(path)
        episodes = reader.n_trajectories
        reader.close()
        ds = ProprioceptiveDataset(path, ['qpos', 'qvel'], ['contact_state'], CFG5_X_FRAMES,
                                   CFG5_Y_FRAMES, load_to_memory=True, device=DEVICE)
        n = min(CFG5_READ_BATCH, len(ds))
        x, y = next(ds.as_batches(n, seed=SEED))
        read_s = time.perf_counter() - t0
        # sample j is window j % W of episode j // W, W windows of 5 steps per episode
        W = T - max(CFG5_X_FRAMES, CFG5_Y_FRAMES) + 1
        j = torch.as_tensor(np.random.RandomState(SEED).permutation(len(ds))[:n], device=DEVICE)
        frames = (j % W)[:, None] + torch.arange(CFG5_X_FRAMES, device=DEVICE)
        tid = (j // W)[:, None]
        g_obs = {n: obs[n][rows] for n in CFG5_OBS}
        want_x = {n: g_obs[n][tid, frames] for n in ('qpos', 'qvel')}
        want_y = g_obs['contact_state'][tid, frames[:, -CFG5_Y_FRAMES:]]
        exact = (all(torch.equal(x[n], want_x[n]) for n in want_x)
                 and torch.equal(y['contact_state'], want_y))
        log(phase, f'{e.robot_name}: {episodes} episodes of {T} steps written with append_batch '
                   f'in {write_s:.3f} s, {path.stat().st_size / 2**20:.2f} MiB; read back '
                   f'({len(ds)} windows, loaded to {DEVICE}) and one batch of {n} '
                   f'drawn in {read_s:.3f} s: equal to the in-memory observations {exact}')
        if not (exact and episodes == rows.stop - rows.start):
            raise AssertionError(f'{e.robot_name}: the H5 read-back differs from the recording')


def cfg5_profile(run, phase=73, n_steps=1):
    """Phase 73: a `profiling.trace` of n_steps cfg5 steps from the last
    state: the trace file, and each group's env.step (profiler range
    `mixed/<robot>`) host and device ms per step (the port's own kernels,
    launched through ctypes, are listed apart: the profiler gives a range
    only the kernels PyTorch launched in it)."""
    env, state = run['env'], run['states'][CFG5_CHUNK * CFG5_CHUNKS]
    action = run['actions'][-1][-1]
    with profiling.trace(Path(CFG5_DIR) / 'trace') as tr:
        for _ in range(n_steps):
            state = env.step(state, action)[0]
    cuda = torch.autograd.DeviceType.CUDA
    averages = tr.profile.key_averages()
    log(phase, f'trace of {n_steps} cfg5 step{"s" * (n_steps != 1)}: {tr.path} '
               f'({tr.path.stat().st_size / 2**20:.1f} MiB); on {smi()}')
    for e in env.groups:
        ev = [a for a in averages if a.key == f'mixed/{e.robot_name}' and a.device_type != cuda]
        dev = ev[0].device_time_total / 1e3 / n_steps if ev else 0.0
        log(phase, f'  {e.robot_name} env.step: host {ev[0].cpu_time_total / 1e3 / n_steps:.2f} '
                   f'ms, device ' + (f'{dev:.3f} ms' if dev > 0 else 'not measured')
                   + ' per step')
    for name in ('newton_kernel', 'spd_solve_kernel'):
        own = [a for a in averages if a.device_type == cuda and name in a.key]
        log(phase, f'  {name}: device {sum(a.self_device_time_total for a in own) / 1e3:.3f} ms, '
                   f'{sum(a.count for a in own)} launches in {n_steps} steps')


def mixed_phases(spd_fields, newton_fields):
    """Phases 68-73: BASELINE cfg5, the mixed batch against the homogeneous
    envs, card against CPU, checkpoint and resume, record and read back, a
    trace."""
    run = cfg5_main_path()
    spd_fields['cfg5_launches'] = run['launches']['spd_solve']
    newton_fields['cfg5_launches'] = run['launches']['newton_fused']
    spd_fields.update(run['fields']['spd'])
    newton_fields.update(run['fields']['newton'])
    bar = cfg5_against_homogeneous(run)
    cfg5_card_against_cpu(run)
    cfg5_resume(run, bar)
    cfg5_record(run)
    cfg5_profile(run)


# ---- phases 74-78: the single-env gym adapter, go2 on ramp, slippery and stairs,
# parallel/ on nccl ----------------------------------------------------------------------

# phase 74: the adapter's steps on go2/flat (60: their rate is steady by then, and
# the run's clock is tight), and where Camera.save writes (build/
# is not committed)
GYM_STEPS = 60
GYM_DIR = 'build/gym'
# Phase 74 holds each accessor of the card's f32 adapter against the CPU's f64
# adapter at the same state (moved to the origin), relative to 1 + max|f64|:
# those of the kinematics and the smooth dynamics within GYM_SMOOTH_BAR (f32
# rounding of quantities up to ~1e2, as the SPD kernel's 1e-4), and those
# that read the Forward's Newton solve at the cap of 10 (`work`, the feet's
# forces) within GYM_SOLVE_BAR. That standing state's solve converges: the
# card read 5.7e-07-7.2e-07 for `work` and 8.3e-06-1.7e-05 for the forces
# (NVIDIA H100 80GB HBM3, 700 W, PERF.md), while an f64 solve stopped at a
# cap of 3 read 8.6e-02 and 1.43 there (the control the phase prints). The
# feet's contact flags must agree.
GYM_SMOOTH_BAR = 1e-4
GYM_SOLVE_BAR = 1e-3
GYM_CONTROL_CAP = 3
GYM_SOLVE_ACCESSORS = ('work', 'feet_contact_state')
GYM_ACCESSORS = (
    ('qpos', None), ('qvel', None), ('base_pos', None), ('base_ori_quat_wxyz', None),
    ('simulation_time', None), ('torque_ctrl_setpoint', None), ('base_configuration', None),
    ('heading_orientation_SO3', None), ('base_ori_euler_xyz', None), ('gravity_vector', None),
    ('joint_space_state', None), ('kinetic_energy', None), ('work', None),
    ('legs_mass_matrix', None), ('legs_qfrc_bias', None), ('legs_qfrc_passive', None),
    ('com', None), ('feet_pos', ('world',)), ('feet_pos', ('base',)),
    ('feet_jacobians', ('world',)), ('feet_jacobians', ('base',)),
    ('feet_jacobians_dot', ('world',)), ('feet_jacobians_dot', ('base',)),
    ('feet_vel', ('world', False)), ('feet_vel', ('base', True)),
    ('hip_positions', ('world',)), ('hip_positions', ('base',)), ('get_base_inertia', ()),
    ('base_lin_vel', ('base',)), ('base_ang_vel', ('world',)), ('target_base_vel', ('base',)),
    ('base_lin_vel_err', ('world',)), ('base_ang_vel_err', ('base',)),
    ('base_lin_acc', ('base',)), ('feet_contact_state', ('base', True)),
)
# phases 75-77: go2's scenes with world geometry, steps on the card and envs
# stepped on the CPU from step 0
GO2_SCENES = ('ramp', 'slippery', 'stairs')
# go2/slippery's feet on the 0.03 surface: a cone of friction 0.03 scales its
# rows' curvature by ~1/mu^2, and on the last step's converged envs the kernel
# and the eager f32 solve both end 4.568e-04 from an eager f64 solve and
# 1.188e-04 from each other (NVIDIA H100 80GB HBM3, 700 W, PERF.md): its
# last step is held by `rounding_bars`' rule, the kernel within
# ROUNDING_ERR_SLACK x the eager f32 solve's distance from f64
ROUNDING_SCENES = ('slippery',)
SCENE_STEPS = 20
SCENE_CPU_ENVS = 4
# every env starts on a world box; at each later step at least this share
# of the envs still touches one (a stepping trot lifts feet, and a foot on
# the stairs' nose may slip to the tread below)
SCENE_TOUCH_SHARE = 0.95
# phase 78: the env steps of the sharded rollout
PARALLEL_STEPS = 5


def stream_syncs(fn):
    """The explicit stream synchronisations (`torch.cuda.Stream.synchronize`)
    in one call of fn(), which CUDA's sync debug mode does not report."""
    n = [0]
    real = torch.cuda.Stream.synchronize

    def counted(stream):
        n[0] += 1
        return real(stream)

    with mock.patch.object(torch.cuda.Stream, 'synchronize', counted):
        fn()
    return n[0]


def kept_kernel_inputs(fn):
    """(fn(), [(A, b) of each SPD wrapper call in engine], [(M, a_s, efc,
    warmstart) of each Newton wrapper call]) of one call of fn()."""
    kept = {'spd': [], 'newton': []}
    newton, smooth = nf.solve_batched, engine.spd_solve_batched

    def newton_kept(M, a_s, efc, warmstart=None, **kw):
        kept['newton'].append((M, a_s, efc, warmstart))
        return newton(M, a_s, efc, warmstart=warmstart, **kw)

    def spd_kept(A, b):
        kept['spd'].append((A, b))
        return smooth(A, b)

    with mock.patch.object(nf, 'solve_batched', newton_kept), \
            mock.patch.object(engine, 'spd_solve_batched', spd_kept):
        out = fn()
    return out, kept['spd'], kept['newton']


def accessor_values(x):
    """The arrays and scalars of an accessor's value, in order: LegsAttr
    leg by leg, tuples item by item, None left out."""
    if x is None:
        return []
    if hasattr(x, 'to_list'):
        return [v for leg in x.to_list() for v in accessor_values(leg)]
    if isinstance(x, tuple):
        return [v for item in x for v in accessor_values(item)]
    return [x]


def spd_at(A, b, phase, label):
    """The SPD kernel on a step's own system (A, b): against its plain
    version; its time through the C entry point, the plain version's and
    torch.linalg.solve's, and the bound, as phase 4 does at (4096, 18)."""
    B, n = b.shape
    x = spd.spd_solve_batched(A, b)
    torch.cuda.synchronize()
    err = rel_err(x, spd.unrolled_chol_solve_torch(A, b))
    abs_err = (x - spd.unrolled_chol_solve_torch(A, b)).abs().max().item()
    out = torch.empty_like(b)
    args = (A.data_ptr(), b.data_ptr(), out.data_ptr(), B, n,
            torch.cuda.current_stream().cuda_stream)
    spd_c = spd._library(n).gqt_spd_solve_f32
    kernel_ms = median_ms(lambda: spd_c(*args))
    plain_ms = median_ms(lambda: spd.unrolled_chol_solve_torch(A, b), launches=10)
    library_ms = median_ms(lambda: torch.linalg.solve(A, b[..., None]), launches=20)
    bound_ms, bound_by = bound(B * (n * n + 2 * n) * 4, B * (n ** 3 / 3 + 2 * n * n))
    log(phase, f'{label}: SPD kernel at (B={B}, n={n}) vs plain rel err {err:.3e} (max abs '
               f'{abs_err:.3e}); kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, '
               f'torch.linalg.solve {library_ms:.4f} ms, bound {bound_ms:.7f} ms ({bound_by}) = '
               f'{kernel_ms / bound_ms:.0f}x; on {smi()}')
    if not err < 1e-4:
        raise AssertionError(f'SPD kernel off its plain version by {err} at {label}')
    return {'ms': kernel_ms, 'plain_ms': plain_ms, 'library_ms': library_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by, 'max_abs_err': abs_err}


def gym_adapter(phase=74, steps=GYM_STEPS):
    """Phase 74: `QuadrupedGymEnv(robot='go2')` on the card: `reset(seed=0)`,
    then `steps` steps of torques drawn U(-2, 2) N m within the action
    bounds (go2's are unbounded): steps/s beside the bare `env.step` of its core at B=1 in this
    call; SPD and Newton launches per step (2, 1) and per Forward refresh
    (1, 1), counted around each call; host synchronisations per step (CUDA's
    sync debug mode, and the stream synchronisation of the numpy returns).
    On the last step's own inputs the SPD kernel (`spd_at`) and the Newton
    kernel (`newton_timing`, at go2's cap of 30: one env's solve may stop
    unconverged at the step's 10) at B=1. Every accessor against the CPU's f64
    adapter at the same state moved to the origin (GYM_SMOOTH_BAR,
    GYM_SOLVE_BAR), beside a control read through an f64 solve stopped at
    GYM_CONTROL_CAP. `Camera.save` of aliengo's robotcam on the card (where
    PIL is installed)."""
    from gym_quadruped_tpu_torch.env.gym_adapter import QuadrupedGymEnv

    env = QuadrupedGymEnv(robot='go2')
    dm = env.core.model
    if dm.device.type != 'cuda':
        raise AssertionError(f'the adapter\'s model lies on {dm.device}')
    t0 = time.perf_counter()
    obs = env.reset(seed=0)
    reset_s = time.perf_counter() - t0
    low, high = env.core.action_space_bounds()      # unbounded on go2
    actions = np.random.RandomState(SEED).uniform(np.maximum(low, -2.0), np.minimum(high, 2.0),
                                                  (steps, dm.m.nu))
    env.step(actions[0])                        # warm up
    per_step, kinds = [], set()
    sync()
    t0 = time.perf_counter()
    for a in actions:
        before = spd.launches, nf.launches
        obs, reward, term, trunc, info = env.step(a)
        per_step.append((spd.launches - before[0], nf.launches - before[1]))
        kinds.add((type(reward).__name__, type(term).__name__, type(trunc).__name__,
                   type(obs['qpos']).__name__))
    wall = time.perf_counter() - t0
    rate = steps / wall

    core = env.core
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    state, _ = core.reset(gen, 1)
    acts = torch.as_tensor(actions, dtype=torch.float32, device=DEVICE)[:, None]
    core.step(state, acts[0])
    sync()
    t0 = time.perf_counter()
    for a in acts:
        state = core.step(state, a)[0]
    sync()
    bare = steps / (time.perf_counter() - t0)
    log(phase, f'go2/flat QuadrupedGymEnv on {dm.device}: reset(seed=0) {reset_s:.3f} s; {steps} '
               f'steps in {wall:.3f} s = {rate:.2f} steps/s; the bare env.step of its core at '
               f'B=1 in this call {bare:.2f} steps/s (adapter/bare {rate / bare:.3f}); returns '
               f'{sorted(kinds)}; on {smi()}')
    env._fwd = None
    before = spd.launches, nf.launches
    env.fwd
    refresh = (spd.launches - before[0], nf.launches - before[1])
    a = actions[-1]
    debug = sync_count(lambda: env.step(a))
    explicit = stream_syncs(lambda: env.step(a))
    stream_alone = sync_count(lambda: torch.cuda.current_stream().synchronize())
    core_syncs = sync_count(lambda: core.step(state, acts[-1]))
    log(phase, f'launches per adapter.step (spd_solve, newton_fused) {sorted(set(per_step))}, '
               f'per Forward refresh {refresh}; host synchronisations per adapter.step: '
               f'{debug[0]} reported by the sync debug mode (first: {debug[1]}), which reports '
               f'{stream_alone[0]} for a stream synchronisation alone; the adapter makes '
               f'{explicit} stream synchronisation(s) for the numpy returns; its core '
               f'env.step alone {core_syncs[0]}')
    if any(k != (2, 1) for k in per_step) or refresh != (1, 1):
        raise AssertionError(f'adapter launches per step {sorted(set(per_step))}, per '
                             f'refresh {refresh}')
    if explicit != 1 or kinds != {('float', 'bool', 'bool', 'ndarray')}:
        raise AssertionError(f'adapter returns {kinds}; syncs {debug}, {explicit} stream syncs')

    # the last step's kernels on the inputs it gave them, at B=1
    _, spds, newtons = kept_kernel_inputs(lambda: env.step(a))
    spd_fields = spd_at(*spds[0], phase, 'go2/flat adapter, its smooth solve')
    newton = newton_timing(newtons[0], phase, cap=GO2_AGREEMENT_ITERATIONS)

    # every accessor against the CPU's f64 adapter at the same state, at the origin
    dm64 = load_model('go2', 'flat', device='cpu', dtype=torch.float64)
    cpu = QuadrupedGymEnv(robot='go2', model=dm64)
    env._state.qpos[:, :2] = 0.0
    env._fwd = None
    cpu._state = env._state.to('cpu', torch.float64)
    worst, failures = {}, []
    for name, args in GYM_ACCESSORS:
        got, want = (getattr(e, name) if args is None else getattr(e, name)(*args)
                     for e in (env, cpu))
        label = name + ('' if not args else f'({", ".join(map(str, args))})')
        g, w = accessor_values(got), accessor_values(want)
        flags = [(x, y) for x, y in zip(g, w) if isinstance(y, bool)]
        nums = [(np.asarray(x, np.float64), np.asarray(y, np.float64))
                for x, y in zip(g, w) if not isinstance(y, bool)]
        if len(g) != len(w) or any(x != y for x, y in flags):
            failures.append(f'{label}: {got} against {want}')
        err = max(float(np.abs(x - y).max() / (1 + np.abs(y).max())) for x, y in nums)
        bar = GYM_SOLVE_BAR if name in GYM_SOLVE_ACCESSORS else GYM_SMOOTH_BAR
        worst[label] = err
        if not err < bar:
            failures.append(f'{label} {err:.3e} >= {bar}')
    smooth = {k: v for k, v in worst.items() if k.split('(')[0] not in GYM_SOLVE_ACCESSORS}
    top = max(smooth, key=smooth.get)
    contact = env.feet_contact_state()[0]
    # the control: the CPU's f64 adapter read through a Forward whose solve
    # stopped at GYM_CONTROL_CAP, against its own at the cap of 10
    forces = lambda e: np.concatenate([np.asarray(x) for x in
                                       e.feet_contact_state('base', True)[2].to_list()])
    want = cpu.work, forces(cpu)
    s = cpu._state
    cpu._fwd = engine.forward(dm64, s.qpos, s.qvel, s.ctrl, solver_iterations=GYM_CONTROL_CAP)
    control = [float(np.abs(x - y).max() / (1 + np.abs(y).max()))
               for x, y in zip((cpu.work, forces(cpu)), want)]
    cpu._fwd = None
    log(phase, f'{len(GYM_ACCESSORS)} accessors, card f32 against CPU f64 at the same state '
               f'moved to the origin (of 1 + max|f64|): kinematic and smooth at most '
               f'{smooth[top]:.3e} ({top}; bar {GYM_SMOOTH_BAR}); from the Forward\'s Newton '
               f'solve at the cap of 10: work {worst["work"]:.3e}, feet forces '
               f'{worst["feet_contact_state(base, True)"]:.3e} (bar {GYM_SOLVE_BAR}; an f64 '
               f'solve stopped at a cap of {GYM_CONTROL_CAP} reads {control[0]:.3e} and '
               f'{control[1]:.3e} there); feet in contact '
               f'{[leg for leg in ("FL", "FR", "RL", "RR") if contact[leg]]}')
    if failures:
        raise AssertionError('; '.join(failures))

    # Camera.save on the card
    try:
        import PIL  # noqa: F401
    except ImportError:
        log(phase, 'PIL is not installed on this machine: Camera.save (depth.png) is left out')
        return {'launches': per_step, 'refresh': refresh, 'spd': spd_fields, 'newton': newton}
    cam_dm = load_model('aliengo', 'flat', device=DEVICE)
    cam = Camera(cam_dm, **CAMERA_KW)
    qpos = torch.as_tensor(cam_dm.m.key_qpos[0], dtype=torch.float32, device=DEVICE)
    t0 = time.perf_counter()
    out = cam.save(GYM_DIR, qpos)
    save_s = time.perf_counter() - t0
    files = sorted(f.name for f in out.iterdir())
    depth = np.load(out / 'depth.npy')
    same = np.array_equal(depth, cam.shoot(qpos[None])[0][0].cpu().numpy())
    log(phase, f'Camera.save of aliengo\'s robotcam ({CAMERA_KW["width"]} x '
               f'{CAMERA_KW["height"]}) on the card with PIL: {files} in {save_s:.3f} s; '
               f'depth.npy equal to a fresh render {same}, in [{depth.min():.4f}, '
               f'{depth.max():.4f}] m')
    if files != ['depth.npy', 'depth.png', 'points.npy', 'seg.npy'] or not same:
        raise AssertionError(f'Camera.save wrote {files}, depth equal to a render {same}')
    return {'launches': per_step, 'refresh': refresh, 'spd': spd_fields, 'newton': newton}


def go2_scene(scene, phase, steps=SCENE_STEPS):
    """Phases 75-77: go2 on `scene` at B=4096 in f32 from `feature_start`:
    `main_path`'s `steps` steps (steps/s, peak memory, launches per step)
    with the active slots against the world boxes and the envs touching a
    world box counted every step (every env at step 0, at least
    SCENE_TOUCH_SHARE of them at each later step, else the scene holds
    nothing new; the pair friction of those slots); card against CPU f64 on
    SCENE_CPU_ENVS envs over steps 0-20 at a Newton cap of 30; the last
    step's Newton kernel against the eager f32 solve (`newton_timing`); each
    narrow-phase group's stream ms (the world-box groups among them).
    Returns (launches, Newton fields)."""
    dm = load_model('go2', scene, device='cuda', dtype=torch.float32)
    m = dm.m
    lay = constraint_layout(m)
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    t0 = time.perf_counter()
    start = feature_start(dm, BATCH, gen)
    sync()
    parts = [('start', time.perf_counter())]
    boxes = int(((m.geom_bodyid == 0) & (m.geom_type == GEOM_BOX)).sum())
    log(phase, f'go2/{scene}: {boxes} world boxes, {len(lay.con_geom1)} contact slots of which '
               f'{int(world_box_slots(dm).sum())} against a world box; starts on the feature in '
               f'{time.perf_counter() - t0:.2f} s: base x in [{start[:, 0].min().item():.3f}, '
               f'{start[:, 0].max().item():.3f}], z in [{start[:, 2].min().item():.3f}, '
               f'{start[:, 2].max().item():.3f}]')
    incl = dm.const('con_incl', lambda: lay.con_incl)
    mu = dm.const('con_mu_sliding', lambda: lay.con_mu[:, 0])
    counts, last = [], {}

    def on_step(fwd):
        touching = (fwd.contacts.dist < incl) & world_box_slots(dm)
        counts.append(torch.stack([touching.sum(), touching.any(1).sum()]))   # no sync
        last['touching'] = touching

    run = main_path(dm, phase, steps, (0,), SCENE_CPU_ENVS, start=start, on_step=on_step)
    slots, envs = torch.stack(counts).T
    frictions = torch.unique(mu[last['touching'].any(0)]).tolist()
    log(phase, f'go2/{scene}: active slots against the world boxes per step '
               f'{slots.min().item()}-{slots.max().item()} ({slots[-1].item() / BATCH:.3f} per '
               f'env at the last step); envs touching a world box {envs[0].item()} of '
               f'{BATCH} at step 0, {envs.min().item()}-{envs.max().item()} over the steps; '
               f'their pair friction (sliding) '
               f'{[round(x, 4) for x in frictions]}')
    if int(envs[0]) != BATCH or int(envs.min()) < SCENE_TOUCH_SHARE * BATCH:
        raise AssertionError(f'go2/{scene}: {envs[0].item()} of {BATCH} envs touch a world box '
                             f'at step 0 (all must), at least {envs.min().item()} at a step '
                             f'(at least {SCENE_TOUCH_SHARE:.0%} must)')
    parts.append(('main path', time.perf_counter()))
    card_against_cpu(dm, run, phase, ROBOT_CPU_CAP)
    parts.append(('card against CPU', time.perf_counter()))
    newton = newton_timing(run['last'], phase, scene in ROUNDING_SCENES)
    parts.append(('Newton timing', time.perf_counter()))
    narrow_phase_groups(dm, run, phase)
    parts.append(('narrow phase by group', time.perf_counter()))
    log(phase, 'seconds of the phase: ' + ', '.join(
        f'{name} {t - (parts[i - 1][1] if i else t0):.1f}' for i, (name, t) in enumerate(parts)))
    return run['launches'], newton


def parallel_world1(phase=78, steps=PARALLEL_STEPS, K=None):
    """Phase 78: `parallel/` in one process on nccl (world size 1, a free
    localhost port): the mesh, `all_hosts_sum`; a `shard_env` rollout of
    go2/flat at B=4096 over `steps` env steps against the same steps of the
    unsharded env, bit for bit; `MPPI.solve_sharded` against `solve` from
    a generator of the same seed at phase 50's defaults (K=1024, H=24, a
    Newton cap of 4), bit for bit, with the seconds of each. One card
    cannot show scaling."""
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    pdist.initialize(f'localhost:{port}', 1, 0)
    try:
        mesh = pdist.global_mesh()
        total = pdist.all_hosts_sum(2.5)
        log(phase, f'torch.distributed {torch.distributed.get_backend()} world size '
                   f'{pdist.world_size()}: mesh {mesh.shape} on {mesh.device}, all_hosts_sum(2.5) '
                   f'= {total}; one card: no scaling can be measured here')
        env = QuadrupedEnv('go2', ground_friction_coeff=(0.5, 1.5))
        nu = env.model.m.nu
        runs = []
        for sharded in (False, True):
            gen = torch.Generator(device=DEVICE).manual_seed(SEED)
            reset, step = shard_env(env, mesh) if sharded else (env.reset, None)
            state, _ = reset(gen, BATCH)
            plan = torch.rand(BATCH, steps, nu, generator=gen, device=DEVICE) * 4 - 2
            spd.launches = nf.launches = 0
            sync()
            t0 = time.perf_counter()
            runs.append(rollout(env, steps, step)(state, plan))
            sync()
            runs[-1] += (time.perf_counter() - t0, (spd.launches, nf.launches))
        same = all(torch.equal(x, y) for (_, x), (_, y) in zip(
            leaves_with_path(runs[0][:4]), leaves_with_path(runs[1][:4])))
        log(phase, f'go2/flat B={BATCH}: {steps} env steps through rollout, unsharded '
                   f'{runs[0][4]:.3f} s, through shard_env {runs[1][4]:.3f} s; launches '
                   f'{runs[0][5]} and {runs[1][5]}; states, obs, rewards and terminations bit '
                   f'for bit {same}; on {smi()}')
        if not same or runs[1][5] != (2 * steps, steps):
            raise AssertionError('the sharded rollout differs from the unsharded one')

        dm = env.model
        height = float(dm.m.key_qpos[0][2])
        cfg = MPPIConfig() if K is None else MPPIConfig(n_samples=K)
        mppi = MPPI(dm, velocity_tracking_cost(dm, (0.4, 0.0, 0.0), 0.0, height), cfg)
        qpos = torch.as_tensor(dm.m.key_qpos[0], dtype=torch.float32, device=DEVICE)
        qvel = torch.zeros(dm.m.nv, device=DEVICE)
        u0 = torch.zeros(mppi.cfg.horizon, nu, device=DEVICE)
        solves = []
        for fn in (lambda: mppi.solve(torch.Generator(device=DEVICE).manual_seed(SEED), qpos,
                                      qvel, u0),
                   lambda: mppi.solve_sharded(mesh, SEED, qpos, qvel, u0)):
            sync()
            t0 = time.perf_counter()
            u, info = fn()
            sync()
            solves.append((u, info, time.perf_counter() - t0))
        same = (torch.equal(solves[0][0], solves[1][0])
                and all(torch.equal(solves[0][1][k], solves[1][1][k]) for k in ('best_cost', 'ess')))
        log(phase, f'MPPI K={mppi.cfg.n_samples} H={mppi.cfg.horizon} cap '
                   f'{mppi.cfg.solver_iterations}: solve {solves[0][2]:.3f} s, solve_sharded '
                   f'(all-reduces on {torch.distributed.get_backend()}) {solves[1][2]:.3f} s; '
                   f'plan, best cost and ess bit for '
                   f'bit {same} (ess {solves[1][1]["ess"].item():.2f}); on {smi()}')
        if not same:
            raise AssertionError('solve_sharded differs from solve at world size 1')
    finally:
        torch.distributed.destroy_process_group()
    return runs[1][5]


def gym_phases(spd_fields, newton_fields):
    """Phases 74-78: the single-env gym adapter, go2 on ramp, slippery and
    stairs, parallel/ at world size 1."""
    out = gym_adapter()
    spd_fields.update({'gym_b1_' + k: v for k, v in out['spd'].items()})
    spd_fields['gym_launches_per_step'] = out['launches'][-1][0]
    spd_fields['gym_refresh_launches'] = out['refresh'][0]
    newton_fields.update({'gym_b1_' + k: v for k, v in out['newton'].items()})
    newton_fields['gym_launches_per_step'] = out['launches'][-1][1]
    newton_fields['gym_refresh_launches'] = out['refresh'][1]
    for phase, scene in zip((75, 76, 77), GO2_SCENES):
        launches, newton = go2_scene(scene, phase)
        spd_fields[f'go2_{scene}_launches'] = launches['spd_solve']
        newton_fields[f'go2_{scene}_launches'] = launches['newton_fused']
        newton_fields.update({f'go2_{scene}_{k}': v for k, v in newton.items()})
    spd_fields['parallel_launches'], newton_fields['parallel_launches'] = parallel_world1()


# ---- phase 79: the general joint tree ----------------------------------------------------

# the joint tree's steps on the card (its feet land after ~70: the drop of
# 0.1 m takes ~0.14 s), its drop, and the window the CPU's f64 steps
# (20 steps across the landing)
TREE_STEPS = 100
TREE_DROP = 0.1
TREE_WINDOW = 60
TREE_CPU_ENVS = 8
# the card's f32 against the CPU's f64 over the window: BASELINE's bar in qpos
TREE_QPOS_BAR = 1e-3
# The tree's soft states sit at the f32 stopping rule's edge, as hyqreal1's
# do (ROUNDING_ROBOTS): at the cap of 30 the kernel and the eager f32 solve
# part by 2.3e-05-3.1e-05 of 1 + max|qacc| in qacc and 1.9e-04-2.4e-04 in the
# cone forces, in the fixed-count form too (both run the same 30 Newton
# steps), and stop at another iteration in 3,333-3,400 of 4,096 envs; the
# eager f32 solve sits as far from an eager f64 solve as the kernel does
# (NVIDIA H100 80GB HBM3, 700.00 W, PERF.md). The kernel is held to f64 as
# the plain f32 solve is (`rounding_bars`).
TREE_ROUNDING = True


def joint_tree(phase=79, steps=TREE_STEPS):
    """Phase 79: the joint tree (models/fixtures/jointtree-flat.npz, read
    with the port's `Model.load`: a free base, a ball-jointed tail, per leg
    two hinges on one body and a sprung slide joint; nq 23, nv 21) on the
    card at B=4096 in f32: `main_path`'s `steps` steps of seeded U(-2, 2)
    torques from the keyframe raised TREE_DROP with seeded joint offsets, so
    that the feet and the tail land (steps/s, peak memory, 2 SPD and 1
    Newton launches per step, every env finite); the last step's SPD kernel
    (`spd_at`) and Newton kernel (`newton_timing`) at nv = 21 against their
    plain versions on the inputs it gave them; the card against the CPU's
    f64 over steps TREE_WINDOW..+20 at a Newton cap of 30 (the states start
    at the origin), its reading and its ratio to TREE_QPOS_BAR. Before the
    path, phase 5's checks of the Newton kernel at nv = 21 (`newton_agreement`
    at go2's cap of 30) on the tree's soft states.
    Returns (launches, SPD fields, Newton fields)."""
    # go2's names and robot config; the lines name it go2/jointtree
    m = dataclasses.replace(Model.load(JOINT_TREE), scene='jointtree')
    dm = to_device(m, 'cuda', torch.float32)
    t0 = time.perf_counter()
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    start = torch.as_tensor(m.key_qpos[0], dtype=torch.float32, device='cuda').repeat(BATCH, 1)
    start[:, 2] += TREE_DROP
    legs = torch.as_tensor(m.legs_qpos_idx.reshape(-1), device='cuda')
    scale = torch.tensor([0.1, 0.1, 0.01], device='cuda').repeat(4)
    start[:, legs] += (torch.rand(BATCH, 12, generator=gen, device='cuda') * 2 - 1) * scale
    sizes = newton_sizes(m)
    spd_blocks, spd_per_block = spd.occupancy(m.nv)
    nf_blocks, nf_per_block, smem = nf.occupancy(*sizes)
    log(phase, f'joint tree: nq {m.nq}, nv {m.nv}, joint types {m.jnt_type.tolist()} (free 0, '
               f'ball 1, slide 2, hinge 3), at most {int(m.body_jntnum.max())} joints on a body; '
               f'{len(m.contact_pairs)} contact pairs; Newton at (nv, ns, C) = {sizes}: '
               f'{nf_blocks} blocks of {nf_per_block} envs per SM, {smem} B of shared memory '
               f'per block; SPD at n = {m.nv}: {spd_blocks} blocks of {spd_per_block} systems '
               f'per SM; dropped from {TREE_DROP} m above the keyframe')
    # phase 5's checks at nv = 21 on the tree's soft states (its feet and tail
    # pressed into the floor; a hip past its range in a quarter of the envs),
    # at go2's cap of 30 (impratio 100 leaves impact states unconverged at
    # 10), under `rounding_bars` (TREE_ROUNDING)
    _, failures, _ = newton_agreement(dm, phase, GO2_AGREEMENT_ITERATIONS, GO2_ITERATION_ENVS_BAR,
                                      rounding=TREE_ROUNDING)
    if failures:
        raise AssertionError('; '.join(failures))
    parts = [('Newton agreement', time.perf_counter())]
    run = main_path(dm, phase, steps, (TREE_WINDOW,), TREE_CPU_ENVS, start=start)
    qpos, qvel, warm = run['state']
    lay = constraint_layout(m)
    kin = kinematics.fk(dm, qpos)
    touching = collision.collide(dm, kin).dist < dm.const('con_incl', lambda: lay.con_incl)
    landed = {m.geom_names[g]: int(touching[:, i].sum()) for i, g in enumerate(lay.con_geom2)}
    log(phase, f'joint tree after {steps} steps: envs whose slot touches, by geom {landed}; '
               f'base height {qpos[:, 2].min().item():.4f}-{qpos[:, 2].max().item():.4f} m')
    parts.append(('main path', time.perf_counter()))

    # the last step's kernels on the inputs it gave them, at nv = 21
    _, spds, _ = kept_kernel_inputs(lambda: engine.step_batched(
        dm, qpos, qvel, torch.zeros(BATCH, m.nu, device='cuda'), warmstart=warm))
    spd_fields = spd_at(*spds[0], phase, 'joint tree, its smooth solve')
    newton = newton_timing(run['last'], phase)
    parts.append(('kernels', time.perf_counter()))

    newton.update(steps_per_s=run['steps_per_s'])

    def then(errs):
        err, = errs
        log(phase, f'joint tree, card f32 against CPU f64 over steps {TREE_WINDOW}..'
                   f'{TREE_WINDOW + CPU_STEPS} at a Newton cap of {ROBOT_CPU_CAP}: max |qpos '
                   f'diff| {err:.3e} = {err / TREE_QPOS_BAR:.4f} of the bar {TREE_QPOS_BAR}',
            late=True)
        newton['card_against_cpu_f64'] = err

    card_against_cpu(dm, run, phase, ROBOT_CPU_CAP, cpu_spec=str(JOINT_TREE), then=then)
    parts.append(('card against CPU, its card side', time.perf_counter()))
    log(phase, 'seconds of the phase: ' + ', '.join(
        f'{name} {t - (parts[i - 1][1] if i else t0):.1f}' for i, (name, t) in enumerate(parts)))
    return run['launches'], spd_fields, newton


# ---- phase 80: the joint tree on random_pyramids ----------------------------------------

# the card's steps, and the CPU's f64 window from step 0 (the starts stand
# on the tiers)
PYRAMID_STEPS = 100
PYRAMID_CPU_ENVS = 8


def pyramids(phase=80, steps=PYRAMID_STEPS):
    """Phase 80: the joint tree on random_pyramids
    (models/fixtures/jointtree-random_pyramids.npz, which the port's `build_model`
    compiled from the tree's MJCF as go2's robot file; read with the port's
    `Model.load`, no MuJoCo) on the card at B=4096 in f32: `main_path`'s
    `steps` steps of seeded U(-2, 2) torques from `feature_start` (over the
    pyramid, dropped until the first slot touches); at least
    SCENE_TOUCH_SHARE of the envs on a tier at step 0, feet on the tiers
    (the envs with a foot on one at each step);
    each narrow-phase group's stream and host ms on the last state; the
    last step's SPD and Newton kernels at nv = 21 against their plain
    versions on the inputs it gave them; the card against the CPU's f64 on
    PYRAMID_CPU_ENVS envs over steps 0-20 at a Newton cap of 30, its reading
    and its ratio to TREE_QPOS_BAR. Returns (launches, SPD fields, Newton
    fields)."""
    m = Model.load(JOINT_TREE_PYRAMIDS)
    dm = to_device(m, 'cuda', torch.float32)
    lay = constraint_layout(m)
    t0 = time.perf_counter()
    start = feature_start(dm, BATCH, torch.Generator(device='cuda').manual_seed(SEED))
    sync()
    boxes = np.flatnonzero((m.geom_bodyid == 0) & (m.geom_type == GEOM_BOX))
    sizes = newton_sizes(m)
    spd_blocks, spd_per_block = spd.occupancy(m.nv)
    nf_blocks, nf_per_block, smem = nf.occupancy(*sizes)
    log(phase, f'joint tree on {m.scene}: {len(boxes)} tiers (half-widths '
               f'{[round(float(x), 3) for x in m.geom_size[boxes, 0]]} m, '
               f'{2 * m.geom_size[boxes[0], 2]:.4f} m high, about x = {m.geom_pos[boxes[0], 0]}), '
               f'{len(m.contact_pairs)} contact pairs, {len(lay.con_geom1)} slots of which '
               f'{int(world_box_slots(dm).sum())} against a tier; Newton at (nv, ns, C) = {sizes}: '
               f'{nf_blocks} blocks of {nf_per_block} envs per SM, {smem} B of shared memory per '
               f'block; SPD at n = {m.nv}: {spd_blocks} blocks of {spd_per_block} systems per SM; '
               f'starts in {time.perf_counter() - t0:.2f} s: base x in '
               f'[{start[:, 0].min().item():.3f}, {start[:, 0].max().item():.3f}], z in '
               f'[{start[:, 2].min().item():.3f}, {start[:, 2].max().item():.3f}]')
    parts = [('start', time.perf_counter())]
    incl = dm.const('con_incl', lambda: lay.con_incl)
    feet = dm.const('feet_slot', lambda: np.isin(lay.con_geom2, m.feet_geom_id))
    counts = []

    def on_step(fwd):
        touching = fwd.contacts.dist < incl
        on = touching & world_box_slots(dm)
        counts.append(torch.stack([touching.any(1).sum(), on.any(1).sum(),
                                   (on & feet).any(1).sum()]))   # no sync

    run = main_path(dm, phase, steps, (0,), PYRAMID_CPU_ENVS, start=start, on_step=on_step)
    world, envs, feet_envs = torch.stack(counts).T
    log(phase, f'envs touching a tier {envs[0].item()} of {BATCH} at step 0 (the floor or a '
               f'tier {world[0].item()}), {envs.min().item()}-{envs.max().item()} over the '
               f'steps; envs with a foot on a tier {feet_envs[0].item()} at step 0, '
               f'{feet_envs.min().item()}-{feet_envs.max().item()} over the steps, '
               f'{feet_envs[-1].item()} at the last')
    # a start over a tier's edge may touch the floor first: the slide joints'
    # offsets of up to 5 cm shift the feet by about half a tier's height
    if int(envs[0]) < SCENE_TOUCH_SHARE * BATCH or int(feet_envs.max()) == 0:
        raise AssertionError(f'{envs[0].item()} of {BATCH} envs on a tier at step 0 (at least '
                             f'{SCENE_TOUCH_SHARE:.0%} must), at most {feet_envs.max().item()} '
                             f'with a foot on one (some must)')
    parts.append(('main path', time.perf_counter()))
    groups = narrow_phase_groups(dm, run, phase)
    parts.append(('narrow phase by group', time.perf_counter()))

    qpos, qvel, warm = run['state']
    _, spds, _ = kept_kernel_inputs(lambda: engine.step_batched(
        dm, qpos, qvel, torch.zeros(BATCH, m.nu, device='cuda'), warmstart=warm))
    spd_fields = spd_at(*spds[0], phase, 'joint tree on the pyramids, its smooth solve')
    newton = newton_timing(run['last'], phase)
    parts.append(('kernels', time.perf_counter()))

    newton.update(steps_per_s=run['steps_per_s'], narrow_phase_stream_ms=groups)

    def then(errs):
        err, = errs
        log(phase, f'joint tree on {m.scene}, card f32 against CPU f64 over steps 0..{CPU_STEPS} '
                   f'at a Newton cap of {ROBOT_CPU_CAP}: max |qpos diff| {err:.3e} = '
                   f'{err / TREE_QPOS_BAR:.4f} of the bar {TREE_QPOS_BAR}', late=True)
        newton['card_against_cpu_f64'] = err

    card_against_cpu(dm, run, phase, ROBOT_CPU_CAP, cpu_spec=str(JOINT_TREE_PYRAMIDS), then=then)
    parts.append(('card against CPU, its card side', time.perf_counter()))
    log(phase, 'seconds of the phase: ' + ', '.join(
        f'{name} {t - (parts[i - 1][1] if i else t0):.1f}' for i, (name, t) in enumerate(parts)))
    return run['launches'], spd_fields, newton


def tree_phases(spd_fields, newton_fields):
    """Phases 79-80: the general joint tree, on its floor and on
    random_pyramids. Their Newton fields are read once their CPU
    comparisons are done (`drain`)."""
    outs = [(prefix, *fn()) for prefix, fn in (('tree_', joint_tree), ('pyramids_', pyramids))]
    drain()
    for prefix, launches, spd_out, newton in outs:
        spd_fields.update({prefix + k: v for k, v in spd_out.items()})
        spd_fields[prefix + 'launches'] = launches['spd_solve']
        newton_fields.update({prefix + k: v for k, v in newton.items()})
        newton_fields[prefix + 'launches'] = launches['newton_fused']


# ---- phase 81: the example drives and the live plotter -----------------------------------

# go2_mpc_locomotion's seconds on the card: 500 steps at B=1 and 100 warm replans
EXAMPLE_SECONDS = 1.0
# the window its vx is read over: the last 0.5 s
EXAMPLE_VX_STEPS = 250
# the h5py drives' sizes where h5py is installed (aliengo_dataset's episodes and
# steps, dataset_reproduction's steps), and where the drives write (build/ is
# not committed)
EXAMPLE_DATASET = (4, 50)
EXAMPLE_REPRODUCTION_STEPS = 50
EXAMPLES_DIR = 'build/examples'
# the live plotter's frames, and the child's join timeout in MultiLivePlotter.close
PLOTTER_FRAMES = 100
PLOTTER_JOIN_S = 2.0


def counted_drive(fn):
    """(fn()'s result, its printed lines, the (SPD, Newton) launches and
    the host synchronisations of each `QuadrupedEnv.step` in it): the
    counts set to 0 just before fn and read just after, CUDA's sync debug
    mode on throughout."""
    per_step, syncs = [], []
    step = QuadrupedEnv.step
    buf = io.StringIO()

    def counted(self, *args, **kwargs):
        before = spd.launches, nf.launches, len(caught)
        out = step(self, *args, **kwargs)
        per_step.append((spd.launches - before[0], nf.launches - before[1]))
        syncs.append(sum('synchroniz' in str(w.message) for w in caught[before[2]:]))
        return out

    sync()
    spd.launches = nf.launches = 0
    if torch.device(DEVICE).type == 'cuda':
        torch.cuda.set_sync_debug_mode('warn')
    try:
        with warnings.catch_warnings(record=True) as caught, \
                mock.patch.object(QuadrupedEnv, 'step', counted), contextlib.redirect_stdout(buf):
            warnings.simplefilter('always')
            out = fn()
    finally:
        if torch.device(DEVICE).type == 'cuda':
            torch.cuda.set_sync_debug_mode('default')
    launches = {'spd_solve': spd.launches, 'newton_fused': nf.launches}
    all_syncs = sum('synchroniz' in str(w.message) for w in caught)
    return out, buf.getvalue().splitlines(), launches, per_step, syncs, all_syncs


def example_go2_mpc(phase, seconds):
    """go2_mpc_locomotion.main on the card: its lines, steps/s and solves/s,
    launches and host syncs per env.step, z, vx over the last
    EXAMPLE_VX_STEPS against the command, the contact flags; upright and
    finite. Both kernels against their plain versions on the inputs of one
    more step from its last state and torques (the Newton kernel at go2's
    cap of 30, as phase 74 at B=1)."""
    from gym_quadruped_tpu_torch.examples import go2_mpc_locomotion

    t0 = time.perf_counter()
    out, lines, launches, per_step, syncs, all_syncs = counted_drive(
        lambda: go2_mpc_locomotion.main(seconds=seconds, device=DEVICE))
    total_s = time.perf_counter() - t0
    for line in lines:
        log(phase, f'go2_mpc_locomotion: {line}')
    steps, solves, wall = out['steps'], out['solves'], out['wall']
    state = out['state']
    z = float(state.qpos[0, 2])
    R22 = float(kinematics.quat_to_mat(state.qpos[:, 3:7])[0, 2, 2])
    vx = float(out['vx'][-EXAMPLE_VX_STEPS:].mean())
    contacts = out['obs']['contact_state'][0].tolist()
    log(phase, f'go2_mpc_locomotion --seconds {seconds} on {state.qpos.device}: {steps} steps and '
               f'{solves} warm solves (and 1 cold) in {wall:.3f} s of loop = '
               f'{steps / wall:.3f} steps/s, {solves / wall:.3f} solves/s ({total_s:.3f} s with '
               f'the model, the reset and the cold solve); on {smi()}')
    log(phase, f'launches: spd_solve {launches["spd_solve"]}, newton_fused '
               f'{launches["newton_fused"]} (per env.step {sorted(set(per_step))}, the reset\'s '
               f'step among them); host synchronisations per env.step (sync debug mode) mean '
               f'{np.mean(syncs):.3f}, max {max(syncs)}; {all_syncs} in the whole drive (its '
               f'reset, the history\'s one copy and the progress lines among them)')
    log(phase, f'after {steps} steps: z {z:.4f} m, R22 {R22:.4f}; vx over the last '
               f'{EXAMPLE_VX_STEPS} steps {vx:.4f} m/s against the command 0.4; contact flags '
               f'{contacts}')
    if launches['spd_solve'] == 0 or launches['newton_fused'] == 0:
        raise AssertionError(f'the MPC drive launched no kernel: {launches}')
    if any(k != (2, 1) for k in per_step) or len(per_step) != steps:
        raise AssertionError(f'launches per env.step {sorted(set(per_step))} in '
                             f'{len(per_step)} steps')
    if launches != {'spd_solve': 2 * (steps + 1), 'newton_fused': steps + 1}:
        raise AssertionError(f'the MPC drive launched {launches} in {steps} steps and a reset')
    if not (np.isfinite(out['qpos']).all() and 0.2 <= z <= 0.35 and R22 > 0.9):
        raise AssertionError(f'go2 fell or diverged under the MPC drive: z {z}, R22 {R22}')

    _, spds, newtons = kept_kernel_inputs(lambda: out['env'].step(state, out['tau']))
    spd_fields = spd_at(*spds[0], phase, 'go2_mpc_locomotion\'s last state, its smooth solve')
    newton = newton_timing(newtons[0], phase, cap=GO2_AGREEMENT_ITERATIONS)
    newton.update(steps_per_s=steps / wall, solves_per_s=solves / wall)
    return out, launches, spd_fields, newton


def example_sensors(phase):
    """aliengo_with_sensors.main on the card: its lines, the IMU's reading,
    the heightmap's and the depth image's ranges; launches per env.step;
    shapes and finite values. Both kernels against their plain versions on
    the inputs of one more zero-torque step from its last state (the Newton
    kernel at a cap of 30, as the other drives at B=1)."""
    from gym_quadruped_tpu_torch.examples import aliengo_with_sensors

    t0 = time.perf_counter()
    out, lines, launches, per_step, syncs, _ = counted_drive(
        lambda: aliengo_with_sensors.main(device=DEVICE))
    secs = time.perf_counter() - t0
    for line in lines:
        log(phase, f'aliengo_with_sensors: {line}')
    obs = out['obs']
    hm, depth = obs['height_map_z'][0], out['depth']
    log(phase, f'aliengo_with_sensors on {out["state"].qpos.device} in {secs:.3f} s: imu_acc '
               f'{[round(v, 4) for v in obs["imu_acc"][0].tolist()]}, imu_gyro '
               f'{[round(v, 4) for v in obs["imu_gyro"][0].tolist()]}; height_map_z '
               f'{tuple(hm.shape)} in [{hm.min().item():.4f}, {hm.max().item():.4f}] m; depth '
               f'{tuple(depth.shape)} in [{depth.min().item():.4f}, {depth.max().item():.4f}] m; '
               f'launches per env.step {sorted(set(per_step))}, host syncs per env.step mean '
               f'{np.mean(syncs):.3f}; on {smi()}')
    finite = all(bool(torch.isfinite(obs[n]).all()) for n in obs) and bool(
        torch.isfinite(depth).all())
    if not finite or hm.shape != (100,) or depth.shape != (48, 64) or \
            any(k != (2, 1) for k in per_step) or launches['newton_fused'] == 0:
        raise AssertionError(f'aliengo_with_sensors: finite {finite}, heightmap {tuple(hm.shape)}, '
                             f'depth {tuple(depth.shape)}, launches {launches}, per step '
                             f'{sorted(set(per_step))}')

    state = out['state']
    tau = torch.zeros(1, out['env'].model.m.nu, dtype=state.qpos.dtype, device=state.qpos.device)
    gen = torch.Generator(device=state.qpos.device).manual_seed(SEED)
    _, spds, newtons = kept_kernel_inputs(lambda: out['env'].step(state, tau, gen))
    spd_fields = spd_at(*spds[0], phase, 'aliengo_with_sensors\' last state, its smooth solve')
    newton = newton_timing(newtons[0], phase, cap=GO2_AGREEMENT_ITERATIONS)
    return launches, spd_fields, newton


def example_plotter(phase, out):
    """The live plotter fed go2's torques and joint positions from the MPC
    drive (tensors on the card: `send_data` turns them into floats): each
    child process exits with code 0 within its join timeout."""
    from gym_quadruped_tpu_torch.utils.live_plotter import MujocoPlotter

    try:
        import matplotlib  # noqa: F401
        mode = 'with matplotlib (its figure, or the sink where none can be had)'
    except ImportError:
        mode = 'in sink mode (no matplotlib on this machine)'
    plotter = MujocoPlotter()
    plotter.torque_plot()
    plotter.jointpos_plot()
    plotter.start()
    procs = [fig._proc for fig in plotter.plots.values()]
    qpos = torch.as_tensor(out['qpos'][-PLOTTER_FRAMES:], device=DEVICE)
    tau = out['tau'][0]
    names = [f'{leg}_{j}' for leg in plotter.LEGS for j in plotter.JOINTS]
    t0 = time.perf_counter()
    for q in qpos:
        plotter.update('Torque', {f'Torque {n}': tau[i] for i, n in enumerate(names)})
        plotter.update('JointPos', {f'JointPos {n}': q[7 + i] for i, n in enumerate(names)})
    send_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plotter.close()
    close_s = time.perf_counter() - t0
    for proc in procs:
        proc.join(timeout=10.0)
    codes = [proc.exitcode for proc in procs]
    log(phase, f'live plotter {mode}: 2 figures, {2 * len(qpos)} frames of tensors on '
               f'{qpos.device} sent in {send_s:.3f} s; close() in {close_s:.3f} s (join timeout '
               f'{PLOTTER_JOIN_S} s each), the children\'s exit codes {codes}')
    if codes != [0, 0] or close_s >= PLOTTER_JOIN_S:
        raise AssertionError(f'the plotter\'s children exited with {codes} after {close_s} s')


def example_hosts(phase):
    """What this machine may lack: the RGB and viewer paths need `mujoco`,
    the two dataset drives h5py. Each is left out, with a line, only where
    its import fails; else it runs here: Camera.image of the joint tree's
    trunk camera (the tree written as go2's MJCF under EXAMPLES_DIR; where
    no GL context can be made, the RuntimeError that names MUJOCO_GL is
    printed) and aliengo_dataset and dataset_reproduction on the card."""
    try:
        import mujoco  # noqa: F401
    except ImportError:
        log(phase, 'mujoco is not installed on this machine: the RGB image (Camera.image, '
                   'Camera.save(rgb=True)) and the viewer (QuadrupedGymEnv.render) are left out '
                   '(tests/test_torch_render.py holds them against the reference)')
    else:
        rgb_image(phase)
    try:
        import h5py  # noqa: F401
    except ImportError:
        log(phase, 'h5py is not installed on this machine: aliengo_dataset and '
                   'dataset_reproduction are left out (tests/test_torch_examples.py runs them)')
        return
    from gym_quadruped_tpu_torch.examples import aliengo_dataset, dataset_reproduction

    out_dir = Path(EXAMPLES_DIR)
    episodes, steps = EXAMPLE_DATASET
    for name, fn in (('aliengo_dataset', lambda: aliengo_dataset.main(
            episodes, steps, str(out_dir / 'aliengo_dataset.h5'), DEVICE)),
                     ('dataset_reproduction', lambda: dataset_reproduction.main(
                         EXAMPLE_REPRODUCTION_STEPS, str(out_dir / 'go2_trot_dataset.h5'),
                         DEVICE))):
        t0 = time.perf_counter()
        (env2, dataset), lines, launches, per_step, _, _ = counted_drive(fn)
        for line in lines:
            log(phase, f'{name}: {line}')
        log(phase, f'{name} in {time.perf_counter() - t0:.3f} s: launches {launches}, per '
                   f'env.step {sorted(set(per_step))}; the rebuilt env '
                   f'{env2.robot_name}/{env2.scene_name} on {env2.model.device}, {len(dataset)} '
                   f'windows')
        if any(k != (2, 1) for k in per_step) or env2.model.device.type != \
                torch.device(DEVICE).type:
            raise AssertionError(f'{name}: launches per env.step {sorted(set(per_step))}, '
                                 f'env on {env2.model.device}')


# Camera.image of the joint tree's trunk camera, in an interpreter of its own
# (argv: the device, the tree's assets directory): MuJoCo aborts a process at
# its second failed Renderer, and dataset_reproduction's replay makes one.
# Prints one JSON object: the image's shape, dtype and range, or the
# RuntimeError that names MUJOCO_GL where no GL context can be made.
RGB_CHILD = """
import json, os, sys
import torch
from gym_quadruped_tpu_torch.models import builder
from gym_quadruped_tpu_torch.models.model import to_device
from gym_quadruped_tpu_torch.sensors import Camera
device, os.environ['GYM_QUADRUPED_ASSETS'] = sys.argv[1:3]
cam = Camera(to_device(builder.build_model('go2', 'flat'), device), 64, 48, cam_name='trunkcam')
try:
    image = cam.image(torch.as_tensor(cam.model.m.key_qpos[0], device=device))
except RuntimeError as e:
    if 'MUJOCO_GL' not in str(e):
        raise
    print(json.dumps({'no_gl': str(e)[:200]}))
else:
    print(json.dumps({'shape': list(image.shape), 'dtype': str(image.dtype),
                      'min': int(image.min()), 'max': int(image.max())}))
"""


def rgb_image(phase):
    """Camera.image of the joint tree's trunk camera, the tree written as
    go2's robot MJCF (scripts/torch_port/make_joint_tree.py) with a camera
    under EXAMPLES_DIR and compiled by the port's builder, in a fresh
    interpreter (RGB_CHILD)."""
    import importlib.util

    root = Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location(
        'make_joint_tree', root / 'scripts' / 'torch_port' / 'make_joint_tree.py')
    mk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mk)
    path = mk.write_robot_assets(Path(EXAMPLES_DIR).resolve() / 'robot_model')
    path.write_text(path.read_text().replace(
        '<site name="imu"', '<camera name="trunkcam" pos="0.25 0 0.05" '
                            'xyaxes="0 -1 0 0.3 0 1"/><site name="imu"'))
    child = subprocess.run([sys.executable, '-c', RGB_CHILD, DEVICE, str(path.parents[1])],
                           cwd=root, capture_output=True, text=True, timeout=300)
    if child.returncode != 0:
        raise AssertionError(f'Camera.image\'s interpreter exited with {child.returncode}: '
                             f'{child.stderr[-2000:]}')
    got = json.loads(child.stdout.splitlines()[-1])
    if 'no_gl' in got:
        log(phase, f'Camera.image: no GL context on this machine, left out: {got["no_gl"]}')
        return
    log(phase, f'Camera.image of the joint tree\'s trunk camera: {got}')
    if got['shape'] != [48, 64, 3] or got['dtype'] != 'uint8' or got['max'] == 0:
        raise AssertionError(f'Camera.image gave {got}')


def example_phases(spd_fields, newton_fields):
    """Phase 81: the example drives on the card (go2_mpc_locomotion,
    aliengo_with_sensors; the dataset drives and the render paths where
    their packages are installed) and the live plotter."""
    phase = 81
    t0 = time.perf_counter()
    out, launches, spd_out, newton = example_go2_mpc(phase, EXAMPLE_SECONDS)
    spd_fields.update({'examples_b1_' + k: v for k, v in spd_out.items()})
    newton_fields.update({'examples_b1_' + k: v for k, v in newton.items()})
    spd_fields['examples_launches'] = launches['spd_solve']
    newton_fields['examples_launches'] = launches['newton_fused']
    sensors, spd_out, newton = example_sensors(phase)
    spd_fields.update({'examples_sensors_' + k: v for k, v in spd_out.items()})
    newton_fields.update({'examples_sensors_' + k: v for k, v in newton.items()})
    spd_fields['examples_sensors_launches'] = sensors['spd_solve']
    newton_fields['examples_sensors_launches'] = sensors['newton_fused']
    example_plotter(phase, out)
    example_hosts(phase)
    log(phase, f'phase 81 in {time.perf_counter() - t0:.1f} s')


def main():
    try:
        run()
    except Exception:
        # the seconds of each phase so far, then the failure itself
        print(f'[time] seconds per phase until the failure: {phase_seconds()}; '
              f'{time.perf_counter() - T_START:.1f} s in all', flush=True)
        raise
    finally:
        stop_workers()


def run():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--newton-agreement', action='store_true',
                        help='run phases 1 and 5 alone and print their failures')
    parser.add_argument('--terrain', action='store_true',
                        help='run phases 1-2 and 35-41 alone (the perlin scenes)')
    parser.add_argument('--sensors', action='store_true',
                        help='run phases 1-2 and 42-46 alone (the sensors)')
    parser.add_argument('--mpc', action='store_true',
                        help='run phases 1-2 and 47-50 alone (the MPC and MPPI)')
    parser.add_argument('--robots', action='store_true',
                        help='run phases 1-2 and 51-67 alone (go1, mini_cheetah, hyqreal1)')
    parser.add_argument('--mixed', action='store_true',
                        help='run phases 1-2 and 68-73 alone (the mixed batch, BASELINE cfg5)')
    parser.add_argument('--gym', action='store_true',
                        help='run phases 1-2 and 74-78 alone (the gym adapter, go2 on ramp, '
                             'slippery and stairs, parallel/)')
    parser.add_argument('--tree', action='store_true',
                        help='run phases 1-2, 79 and 80 alone (the general joint tree, on its '
                             'floor and on random_pyramids)')
    parser.add_argument('--examples', action='store_true',
                        help='run phases 1-2 and 81 alone (the example drives and the live '
                             'plotter)')
    args = parser.parse_args()
    # ---- 1. the card ---------------------------------------------------------------
    card()
    dm = load_model('spot', 'flat', device='cuda', dtype=torch.float32)
    m = dm.m
    if args.newton_agreement:
        _, failures = spot_agreement(dm)
        for failure in failures:
            log(5, f'FAILED {failure}')
        sys.exit(1 if failures else 0)

    # ---- 2. build, one nvcc per source and size, all in parallel -----------------------
    t_build = time.perf_counter()
    # the joint tree's nv = 21 (phase 79) beside spot's 18 and phase 3's sizes
    builds = [(spd, n) for n in SPD_SIZES] + [(nf, nv) for nv in NEWTON_SIZES]
    with ThreadPoolExecutor(len(builds)) as pool:
        built = list(pool.map(lambda b: b[0].build(b[1]), builds))
    log(2, f'{len(builds)} kernel builds in {time.perf_counter() - t_build:.2f} s')
    for (mod, n), (path, secs, out) in zip(builds, built):
        log(2, f'built {path.name} ({mod.__name__.rsplit(".", 1)[1]}, n={n}) in {secs:.2f} s')
        for line in out.splitlines():
            if 'ptxas' in line or 'registers' in line or 'spill' in line:
                log(2, line.strip())
    sizes = newton_sizes(m)
    spd_blocks, per_block = spd.occupancy(m.nv)
    log(2, f'spd_solve at n={m.nv}: {spd_blocks} blocks of {per_block} systems per SM = '
           f'{spd_blocks * per_block} resident systems per SM')
    nf_blocks, per_block, smem = nf.occupancy(*sizes)
    log(2, f'newton_fused at (nv, ns, C)={sizes}: {nf_blocks} blocks of {per_block} envs per '
           f'SM = {nf_blocks * per_block} resident envs per SM, {smem} B of shared memory '
           f'per block ({smem / per_block / 1024:.2f} KB per env)')

    spd_fields = {}
    newton_fields = {}
    rates = {}
    if args.terrain or args.sensors or args.mpc or args.robots or args.mixed or args.gym \
            or args.tree or args.examples:
        if args.terrain:
            terrain_phases(spd_fields, newton_fields, rates)
        elif args.sensors:
            sensor_phases(spd_fields, newton_fields)
        elif args.robots:
            robot_phases(spd_fields, newton_fields, rates)
        elif args.mixed:
            mixed_phases(spd_fields, newton_fields)
        elif args.gym:
            gym_phases(spd_fields, newton_fields)
        elif args.tree:
            tree_phases(spd_fields, newton_fields)
        elif args.examples:
            example_phases(spd_fields, newton_fields)
        else:
            mpc_phases(spd_fields, newton_fields)
        drain()
        log('time', f'seconds per phase: {phase_seconds()}; '
                    f'{time.perf_counter() - T_START:.1f} s in all')
        print(json.dumps({'launches and timings of these phases': {
            'spd_solve': spd_fields, 'newton_fused': newton_fields}}))
        print_ok()
        return

    # ---- 3. kernel against plain, on the card ----------------------------------------
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    max_abs_err = None
    for B, n in [(4096, 18), (4097, 18), (100, 7), (64, 32)]:
        A, b = random_spd(gen, B, n)
        x = spd.spd_solve_batched(A, b)
        torch.cuda.synchronize()
        x_plain = spd.unrolled_chol_solve_torch(A, b)
        x64 = torch.linalg.solve(A.double(), b.double()[..., None])[..., 0]
        e_plain, e64 = rel_err(x, x_plain), rel_err(x, x64)
        abs_err = (x - x_plain).abs().max().item()
        log(3, f'(B={B}, n={n}): rel err vs plain {e_plain:.3e}, vs f64 {e64:.3e}, '
               f'max abs vs plain {abs_err:.3e}')
        # f32 Cholesky of well-conditioned systems: the bar of the reference's
        # own kernel test (tests/test_spd_solve.py)
        if not (e_plain < 1e-4 and e64 < 1e-4):
            raise AssertionError(f'SPD kernel disagrees at (B={B}, n={n})')
        if (B, n) == (4096, 18):
            max_abs_err = abs_err

    # ---- 4. timings at the main path's shape -----------------------------------------
    B, n = BATCH, 18
    A, b = random_spd(gen, B, n)
    x = torch.empty_like(b)
    args = (A.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, torch.cuda.current_stream().cuda_stream)
    spd_c = spd._library(n).gqt_spd_solve_f32
    kernel_ms = median_ms(lambda: spd_c(*args))
    wrapper_ms = median_ms(lambda: spd.spd_solve_batched(A, b))
    plain_ms = median_ms(lambda: spd.unrolled_chol_solve_torch(A, b), launches=10)
    library_ms = median_ms(lambda: torch.linalg.solve(A, b[..., None]), launches=20)
    n_bytes = B * (n * n + 2 * n) * 4
    n_flop = B * (n ** 3 / 3 + 2 * n * n)
    bound_ms, bound_by = bound(n_bytes, n_flop)
    log(4, f'(4096, 18): kernel {kernel_ms:.4f} ms (through the wrapper {wrapper_ms:.4f} ms), '
           f'plain {plain_ms:.4f} ms, torch.linalg.solve {library_ms:.4f} ms, bound '
           f'{bound_ms:.5f} ms ({bound_by}: {n_bytes / 1e6:.2f} MB, {n_flop / 1e6:.2f} MFLOP)')

    # ---- 5-29. per main path: Newton agreement, the path, card against CPU, Newton
    # timings, profile and narrow phase by group
    for entry in SCENES[:5]:
        rates[entry[1:3]] = scene_phases(entry, spd_fields, newton_fields)

    # ---- 30-34. the env layer: go2/flat, all observables, card against CPU,
    # quarantine; hyqreal2/random_boxes
    run = env_main_path(rates['go2', 'flat'], steps=ENV_STEPS)
    env_all_obs(run)
    env_card_against_cpu(run)
    env_quarantine(run)
    spd_fields['env_launches'] = run['launches']['spd_solve']
    newton_fields['env_launches'] = run['launches']['newton_fused']
    del run
    env_random_boxes()

    terrain_phases(spd_fields, newton_fields, rates)

    # ---- 42-46. the sensors: BASELINE cfg3, card against CPU, heightmaps on
    # terrain, the depth camera, the camera through the env
    sensor_phases(spd_fields, newton_fields)

    # ---- 47-50. the centroidal MPC: solves/s at H=12, the go2/flat closed loop,
    # card against CPU, MPPI
    mpc_phases(spd_fields, newton_fields)

    # ---- 51-67. go1, mini_cheetah and hyqreal1: the per-slot contact rows, the
    # Newton kernel past 160 rows, the mesh colliders; BASELINE cfg1's env; their
    # perlin scenes
    robot_phases(spd_fields, newton_fields, rates)

    # ---- 68-73. BASELINE cfg5: go2, aliengo and mini_cheetah in one batch with
    # aliengo's camera; against the homogeneous envs and the CPU; checkpoint and
    # resume; record and read back; a trace
    mixed_phases(spd_fields, newton_fields)

    # ---- 74-78. the single-env gym adapter at B=1; go2 on ramp, slippery and
    # stairs; parallel/ at world size 1 on nccl
    gym_phases(spd_fields, newton_fields)

    # ---- 79-80. the general joint tree: ball, slide and two joints on a body; both
    # kernels at nv = 21; then on random_pyramids, compiled by the port itself
    tree_phases(spd_fields, newton_fields)

    # ---- 81. the example drives on the card, the live plotter
    example_phases(spd_fields, newton_fields)
    drain()

    log('time', f'seconds per phase (from the last line of the phase before): '
                f'{phase_seconds()}; {time.perf_counter() - T_START:.1f} s in all')
    print(json.dumps({'kernels': [{
        'name': 'spd_solve', 'route': 'cuda',
        'source': 'gym_quadruped_tpu_torch/csrc/spd_solve.cu',
        'replaces': 'gym_quadruped_tpu/ops/spd_solve.py:37',
        'max_abs_err': max_abs_err, 'ms': kernel_ms, 'plain_ms': plain_ms,
        'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': library_ms,
        'sizes_built': list(SPD_SIZES), **spd_fields}, {
        'name': 'newton_fused', 'route': 'cuda',
        'source': 'gym_quadruped_tpu_torch/csrc/newton_fused.cu',
        'replaces': 'scripts/experimental/newton_solve.py:144, '
                    'scripts/experimental/newton_bt.py:272',
        'library_ms': None, 'sizes_built': list(NEWTON_SIZES), **newton_fields}]}))
    print_ok()


def print_ok():
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
