#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. the card: require CUDA, print `nvidia-smi` name and power limit, turn
     TF32 off for matmuls and cuDNN;
  2. build csrc/spd_solve.cu with nvcc for sm_90a (print seconds and ptxas);
  3. the SPD kernel against its plain version and a float64 solve on seeded
     SPD systems at (4096, 18), (4097, 18), (100, 7) and (64, 32);
  4. timings at (4096, 18) with CUDA events: kernel, plain version,
     torch.linalg.solve (yardstick only) and the memory/compute bound;
  5. the main path: spot/flat, B=4096, f32, 200 steps of `step_batched` from
     the keyframe with seeded U(-2, 2) torques and the qacc warm start; every
     state finite, contacts active, 2 to 12 kernel launches per step;
  6. card against CPU: 16 envs stepped 20 times in f64 on the CPU through the
     same functions, from the card's states at steps 0 and 100;
  7. a device profile of 3 steps: busy share, host and device time of the
     step's stages (smooth, contacts, newton, euler), top kernels.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from gym_quadruped_tpu_torch.models.model import load_model
from gym_quadruped_tpu_torch.ops import spd_solve as spd
from gym_quadruped_tpu_torch.physics import engine

SEED = 0
BATCH = 4096
STEPS = 200
N_CPU_ENVS = 16
CPU_STEPS = 20
CPU_WINDOWS = (0, 100)     # card states the CPU comparison starts from
# H100 SXM published peaks: HBM bytes/s, f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def log(phase, msg):
    print(f'[{phase}] {msg}', flush=True)


def random_spd(gen, B, n):
    X = torch.randn(B, n, n, generator=gen, device='cuda')
    A = X @ X.transpose(1, 2) + n * torch.eye(n, device='cuda')
    b = torch.randn(B, n, generator=gen, device='cuda')
    return A.contiguous(), b


def median_ms(fn, launches=100, repeats=7):
    """Median over `repeats` of the mean time of `launches` back-to-back
    calls, timed with CUDA events after a warm-up."""
    for _ in range(5):
        fn()
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


def main():
    # ---- 1. the card ---------------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError('chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(1, f'torch {torch.__version__} cuda {torch.version.cuda} '
           f'device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}; '
           f'matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} '
           f'cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}')

    # ---- 2. build --------------------------------------------------------------------
    path, secs, out = spd.build()
    log(2, f'built {path.name} in {secs:.2f} s')
    for line in out.splitlines():
        if 'ptxas' in line or 'registers' in line or 'spill' in line:
            log(2, line.strip())

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
    kernel_ms = median_ms(lambda: spd.spd_solve_batched(A, b))
    plain_ms = median_ms(lambda: spd.unrolled_chol_solve_torch(A, b), launches=10)
    library_ms = median_ms(lambda: torch.linalg.solve(A, b[..., None]), launches=20)
    n_bytes = B * (n * n + 2 * n) * 4
    n_flop = B * (n ** 3 / 3 + 2 * n * n)
    bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_flop / F32_FLOP_PER_S) * 1e3
    bound_by = 'bytes' if n_bytes / HBM_BYTES_PER_S >= n_flop / F32_FLOP_PER_S else 'operations'
    log(4, f'(4096, 18): kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, '
           f'torch.linalg.solve {library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: '
           f'{n_bytes / 1e6:.2f} MB, {n_flop / 1e6:.2f} MFLOP)')

    # ---- 5. the main path --------------------------------------------------------------
    dm = load_model('spot', 'flat', device='cuda', dtype=torch.float32)
    m = dm.m
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    ctrls = torch.rand(STEPS, BATCH, m.nu, generator=gen, device='cuda') * 4.0 - 2.0
    qpos = torch.as_tensor(np.tile(m.key_qpos[0], (BATCH, 1)), dtype=torch.float32,
                           device='cuda')
    qvel = torch.zeros(BATCH, m.nv, device='cuda')
    warm = torch.zeros(BATCH, m.nv, device='cuda')
    finite = torch.ones((), dtype=torch.bool, device='cuda')
    n_active = torch.zeros((), dtype=torch.int64, device='cuda')
    starts = {}
    per_step = []
    spd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(STEPS):
        if t in CPU_WINDOWS or t - CPU_STEPS in CPU_WINDOWS:
            starts[t] = (qpos[:N_CPU_ENVS].clone(), qvel[:N_CPU_ENVS].clone(),
                         warm[:N_CPU_ENVS].clone())
        before = spd.launches
        qpos, qvel, fwd = engine.step_batched(dm, qpos, qvel, ctrls[t], warmstart=warm)
        warm = fwd.qacc
        per_step.append(spd.launches - before)
        finite &= torch.isfinite(qpos).all() & torch.isfinite(qvel).all()
        n_active += fwd.efc.con_active.sum()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = spd.launches
    log(5, f'spot/flat B={BATCH} f32: {STEPS} steps in {wall:.3f} s = '
           f'{STEPS / wall:.2f} steps/s = {BATCH * STEPS / wall:.1f} env-steps/s')
    log(5, f'spd_solve launches {launches} ({min(per_step)} to {max(per_step)} per step, '
           f'mean {launches / STEPS:.2f}); active contact slots summed over steps '
           f'{int(n_active)}; final mean base height {qpos[:, 2].mean().item():.4f}')
    if not bool(finite):
        raise AssertionError('a state of the main path is not finite')
    if int(n_active) == 0:
        raise AssertionError('no contact became active: the contact path was not exercised')
    if not all(2 <= k <= 12 for k in per_step):
        raise AssertionError(f'spd_solve launches per step outside [2, 12]: {per_step}')

    # ---- 6. card against CPU ------------------------------------------------------------
    torch.set_num_threads(1)   # tiny batched products: one thread is fastest
    dm64 = load_model('spot', 'flat', device='cpu', dtype=torch.float64)
    for t0_ in CPU_WINDOWS:
        q, v, w = (x.double().cpu() for x in starts[t0_])
        for t in range(t0_, t0_ + CPU_STEPS):
            q, v, f = engine.step_batched(dm64, q, v, ctrls[t, :N_CPU_ENVS].double().cpu(),
                                          warmstart=w)
            w = f.qacc
        card_q = starts[t0_ + CPU_STEPS][0].double().cpu()
        err = (card_q - q).abs().max().item()
        log(6, f'{N_CPU_ENVS} envs, steps {t0_}..{t0_ + CPU_STEPS}: card f32 vs CPU f64 '
               f'max |qpos diff| {err:.3e}')
        # f32 steps against f64 steps: the f32 Newton tolerance is 1e-6 of
        # |qacc| and 20 steps of 2 ms keep the drift far below the 1e-3 qpos
        # bar that the reference holds against MuJoCo
        if not err < 1e-3:
            raise AssertionError(f'card and CPU trajectories differ by {err}')

    # ---- 7. device profile of a few steps -----------------------------------------------
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for t in range(3):
            qpos, qvel, fwd = engine.step_batched(dm, qpos, qvel, ctrls[t], warmstart=warm)
            warm = fwd.qacc
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    # the stage ranges appear twice: as host ranges (their device time is the
    # kernels they launched) and as device-side annotations, kept out of the
    # kernel sums
    stages = ('smooth', 'contacts', 'newton', 'euler')
    cuda = torch.autograd.DeviceType.CUDA
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == cuda and e.key not in stages]
    dev_us = sum(e.self_device_time_total for e in kernels)
    if dev_us > 0:
        log(7, f'3 steps: wall {prof_wall * 1e3:.1f} ms (profiled), device busy '
               f'{dev_us / 1e3:.1f} ms = {dev_us / 1e4 / prof_wall:.1f}%; kernel launches '
               f'{sum(e.count for e in kernels)}')
        for e in averages:
            if e.key in stages and e.device_type != cuda:
                log(7, f'  stage {e.key:8s} host {e.cpu_time_total / 1e3:8.2f} ms, '
                       f'device {e.device_time_total / 1e3:8.3f} ms')
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
            log(7, f'  {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x  {e.key[:90]}')
    else:
        log(7, 'the profiler recorded no device time: busy share not measured')

    print(json.dumps({'kernels': [{
        'name': 'spd_solve', 'route': 'cuda',
        'source': 'gym_quadruped_tpu_torch/csrc/spd_solve.cu',
        'replaces': 'gym_quadruped_tpu/ops/spd_solve.py:37',
        'launches': launches, 'max_abs_err': max_abs_err,
        'ms': kernel_ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
        'bound_by': bound_by, 'library_ms': library_ms}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
