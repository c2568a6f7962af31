#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. the card: require CUDA, print `nvidia-smi` name and power limit, turn
     TF32 off for matmuls and cuDNN;
  2. build csrc/spd_solve.cu and csrc/newton_fused.cu with nvcc for sm_90a,
     one nvcc each, in parallel (print seconds and ptxas);
  3. the SPD kernel against its plain version and a float64 solve on seeded
     SPD systems at (4096, 18), (4097, 18), (100, 7) and (64, 32);
  4. SPD timings at (4096, 18) with CUDA events: kernel, plain version,
     torch.linalg.solve (yardstick only) and the memory/compute bound;
  5. the fused Newton kernel against its plain version (the eager
     `solver.solve` on the card) in both forms (per-env stopping and a fixed
     count), from a_smooth and from zeros, on seeded soft spot/flat contact
     states at B=4096 and B=4097; repeated launches bitwise identical;
  6. the main path: spot/flat, B=4096, f32, 200 steps of `step_batched` from
     the keyframe with seeded U(-2, 2) torques and the qacc warm start; every
     state finite, contacts active, exactly 2 SPD and 1 Newton kernel
     launches per step;
  7. card against CPU: 16 envs stepped 20 times in f64 on the CPU through the
     same functions, from the card's states at steps 0 and 100;
  8. Newton timings on the main path's last step inputs, in both forms: the
     fused kernel, the eager `solver.solve` on the card (the previous Newton
     stage) and the bound from the iterations the kernel ran;
  9. a device profile of 3 steps: busy share, kernel launches per step, host
     and device time of the step's stages (smooth, contacts, newton, euler)
     and of the port's two kernels, top kernels.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gym_quadruped_tpu_torch.models.model import load_model
from gym_quadruped_tpu_torch.ops import newton_fused as nf
from gym_quadruped_tpu_torch.ops import spd_solve as spd
from gym_quadruped_tpu_torch.physics import engine, solver

SEED = 0
BATCH = 4096
STEPS = 200
N_CPU_ENVS = 16
CPU_STEPS = 20
CPU_WINDOWS = (0, 100)     # card states the CPU comparison starts from
# H100 SXM published peaks: HBM bytes/s, f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# the fused kernel against the eager solve: relative to 1 + max|reference|
NEWTON_BAR = 1e-4
LS_ITERATIONS = 6


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


def bound(n_bytes, n_flop):
    """(bound ms, 'bytes' or 'operations'): the larger of the two times."""
    t_bytes, t_flop = n_bytes / HBM_BYTES_PER_S, n_flop / F32_FLOP_PER_S
    return max(t_bytes, t_flop) * 1e3, 'bytes' if t_bytes >= t_flop else 'operations'


def soft_state(dm, gen, B):
    """M, a_smooth and the rows of B seeded spot/flat states: the keyframe
    lowered U(0, 5) mm into the floor, qvel 0, U(-0.5, 0.5) torques."""
    m = dm.m
    qpos = torch.as_tensor(m.key_qpos[0], dtype=torch.float32, device='cuda').repeat(B, 1)
    qpos[:, 2] -= 0.005 * torch.rand(B, generator=gen, device='cuda')
    ctrl = torch.rand(B, m.nu, generator=gen, device='cuda') - 0.5
    fwd = engine.forward(dm, qpos, torch.zeros(B, m.nv, device='cuda'), ctrl)
    return fwd.M, fwd.qacc_smooth, fwd.efc


def newton_flop(nv, ns, C, env_iterations, B, ls=LS_ITERATIONS):
    """Floating-point operations of the fused Newton solve, counted from its
    code (csrc/newton_fused.cu): per env and iteration, times the iterations
    the envs ran, plus the final forces once per env."""
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

    # ---- 2. build, one nvcc per source, in parallel -----------------------------------
    t_build = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        builds = list(pool.map(lambda mod: mod.build(), (spd, nf)))
    log(2, f'both kernels built in {time.perf_counter() - t_build:.2f} s')
    for path, secs, out in builds:
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
    bound_ms, bound_by = bound(n_bytes, n_flop)
    log(4, f'(4096, 18): kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, '
           f'torch.linalg.solve {library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: '
           f'{n_bytes / 1e6:.2f} MB, {n_flop / 1e6:.2f} MFLOP)')

    # ---- 5. the fused Newton kernel against its plain version -------------------------
    dm = load_model('spot', 'flat', device='cuda', dtype=torch.float32)
    m = dm.m
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    newton_abs_err = None
    forms = (('solve_batched', nf.solve_batched, None),
             ('solve_batched_bt', nf.solve_batched_bt, 0.0))
    for B in (BATCH, BATCH + 1):
        M, a_s, efc = soft_state(dm, gen, B)
        log(5, f'B={B}: ns={efc.J.shape[1]}, C={efc.con_J.shape[1]}, active cone blocks '
               f'per env {efc.con_active.sum(1).float().mean().item():.2f}')
        for form, fn, tol in forms:
            for start, warm in (('a_smooth', None), ('zeros', torch.zeros_like(a_s))):
                it = torch.zeros(B, dtype=torch.int32, device='cuda')
                got = fn(M, a_s, efc, warmstart=warm, iterations_out=it)
                again = fn(M, a_s, efc, warmstart=warm)
                torch.cuda.synchronize()
                it_ref = torch.zeros_like(it)
                ref = solver.solve(M, a_s, efc, warm, iterations_out=it_ref, _tol=tol)
                errs = [rel_err(g, r) for g, r in zip(got, ref)]
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                log(5, f'B={B} {form} from {start}: rel err vs plain qacc {errs[0]:.3e}, '
                       f'f_simple {errs[1]:.3e}, f_cone {errs[2]:.3e}, qfrc {errs[3]:.3e}; '
                       f'max|qacc| {ref[0].abs().max().item():.2f}; mean iterations kernel '
                       f'{it.float().mean().item():.3f}, plain {it_ref.float().mean().item():.3f}; '
                       f'repeat bitwise equal {same}')
                # soft states converge in f32; the bar is 1e-4 of 1 + max|ref|
                if not max(errs) < NEWTON_BAR:
                    raise AssertionError(f'Newton kernel disagrees: B={B} {form} from {start}')
                if not same:
                    raise AssertionError(f'Newton kernel not deterministic: B={B} {form}')
                if (B, form, start) == (BATCH, 'solve_batched', 'a_smooth'):
                    newton_abs_err = (got[0] - ref[0]).abs().max().item()

    # ---- 6. the main path --------------------------------------------------------------
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
    nf.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(STEPS):
        if t in CPU_WINDOWS or t - CPU_STEPS in CPU_WINDOWS:
            starts[t] = (qpos[:N_CPU_ENVS].clone(), qvel[:N_CPU_ENVS].clone(),
                         warm[:N_CPU_ENVS].clone())
        before = spd.launches, nf.launches
        warm_in = warm
        qpos, qvel, fwd = engine.step_batched(dm, qpos, qvel, ctrls[t], warmstart=warm)
        warm = fwd.qacc
        per_step.append((spd.launches - before[0], nf.launches - before[1]))
        finite &= torch.isfinite(qpos).all() & torch.isfinite(qvel).all()
        n_active += fwd.efc.con_active.sum()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, newton_launches = spd.launches, nf.launches
    log(6, f'spot/flat B={BATCH} f32: {STEPS} steps in {wall:.3f} s = '
           f'{STEPS / wall:.2f} steps/s = {BATCH * STEPS / wall:.1f} env-steps/s')
    log(6, f'launches: spd_solve {launches}, newton_fused {newton_launches} '
           f'(per step {sorted(set(per_step))}); active contact slots summed over steps '
           f'{int(n_active)}; final mean base height {qpos[:, 2].mean().item():.4f}')
    if not bool(finite):
        raise AssertionError('a state of the main path is not finite')
    if int(n_active) == 0:
        raise AssertionError('no contact became active: the contact path was not exercised')
    if any(k != (2, 1) for k in per_step):
        raise AssertionError(f'expected 2 spd_solve and 1 newton_fused launch per step, got '
                             f'{sorted(set(per_step))}')
    last = (fwd.M, fwd.qacc_smooth, fwd.efc, warm_in)   # the last step's Newton inputs

    # ---- 7. card against CPU ------------------------------------------------------------
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
        log(7, f'{N_CPU_ENVS} envs, steps {t0_}..{t0_ + CPU_STEPS}: card f32 vs CPU f64 '
               f'max |qpos diff| {err:.3e}')
        # f32 steps against f64 steps: the f32 Newton tolerance is 1e-6 of
        # |qacc| and 20 steps of 2 ms keep the drift far below the 1e-3 qpos
        # bar that the reference holds against MuJoCo
        if not err < 1e-3:
            raise AssertionError(f'card and CPU trajectories differ by {err}')

    # ---- 8. Newton timings on the main path's inputs -------------------------------------
    M, a_s, efc, w = last
    B, nv = a_s.shape
    ns, C = efc.J.shape[1], efc.con_J.shape[1]
    it = torch.zeros(B, dtype=torch.int32, device='cuda')
    outs = nf.solve_batched(M, a_s, efc, warmstart=w, iterations_out=it)
    newton_ms = median_ms(lambda: nf.solve_batched(M, a_s, efc, warmstart=w))
    newton_bt_ms = median_ms(lambda: nf.solve_batched_bt(M, a_s, efc, warmstart=w))
    eager_ms = median_ms(lambda: solver.solve(M, a_s, efc, warmstart=w), launches=3, repeats=3)
    inputs = [M, a_s, w] + [getattr(efc, k) for k in nf.EFC_FLOAT_FIELDS + nf.EFC_MASK_FIELDS]
    n_bytes = sum(x.numel() * x.element_size() for x in inputs + list(outs))
    env_iterations = int(it.sum())
    n_flop = newton_flop(nv, ns, C, env_iterations, B)
    newton_bound_ms, newton_bound_by = bound(n_bytes, n_flop)
    log(8, f'(B={B}, nv={nv}, ns={ns}, C={C}), the last main-path step: fused kernel '
           f'{newton_ms:.4f} ms, eager solver.solve {eager_ms:.4f} ms, bound '
           f'{newton_bound_ms:.5f} ms ({newton_bound_by}: {n_bytes / 1e6:.2f} MB, '
           f'{n_flop / 1e9:.3f} GFLOP over {env_iterations} env-iterations, mean '
           f'{env_iterations / B:.3f}, max {int(it.max())}); no single PyTorch call '
           f'computes a Newton contact solve')
    # the fixed-count form on the same inputs: every env runs 10 iterations
    eager_bt_ms = median_ms(lambda: solver.solve(M, a_s, efc, warmstart=w, _tol=0.0),
                            launches=3, repeats=3)
    bt_flop = newton_flop(nv, ns, C, 10 * B, B)
    bt_bound_ms, bt_bound_by = bound(n_bytes, bt_flop)
    log(8, f'fixed 10 iterations: fused kernel {newton_bt_ms:.4f} ms, eager '
           f'solver.solve {eager_bt_ms:.4f} ms, bound {bt_bound_ms:.5f} ms ({bt_bound_by}: '
           f'{bt_flop / 1e9:.3f} GFLOP)')

    # ---- 9. device profile of a few steps -----------------------------------------------
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
        n_kernels = sum(e.count for e in kernels)
        log(9, f'3 steps: wall {prof_wall * 1e3:.1f} ms (profiled), device busy '
               f'{dev_us / 1e3:.1f} ms = {dev_us / 1e4 / prof_wall:.1f}%; kernel launches '
               f'{n_kernels} = {n_kernels / 3:.1f} per step')
        for e in averages:
            if e.key in stages and e.device_type != cuda:
                log(9, f'  stage {e.key:8s} host {e.cpu_time_total / 1e3:8.2f} ms, '
                       f'device {e.device_time_total / 1e3:8.3f} ms')
        # the profiler gives a stage only the kernels that PyTorch launched in
        # it: the port's own kernels, launched through ctypes, are added here
        for name, stage in (('newton_kernel', 'newton'), ('spd_solve_kernel', 'smooth, euler')):
            own = [e for e in kernels if name in e.key]
            log(9, f'  {name} (stage {stage}): device '
                   f'{sum(e.self_device_time_total for e in own) / 1e3:8.3f} ms, '
                   f'{sum(e.count for e in own)} launches')
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
            log(9, f'  {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x  {e.key[:90]}')
    else:
        log(9, 'the profiler recorded no device time: busy share not measured')

    print(json.dumps({'kernels': [{
        'name': 'spd_solve', 'route': 'cuda',
        'source': 'gym_quadruped_tpu_torch/csrc/spd_solve.cu',
        'replaces': 'gym_quadruped_tpu/ops/spd_solve.py:37',
        'launches': launches, 'max_abs_err': max_abs_err,
        'ms': kernel_ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
        'bound_by': bound_by, 'library_ms': library_ms}, {
        'name': 'newton_fused', 'route': 'cuda',
        'source': 'gym_quadruped_tpu_torch/csrc/newton_fused.cu',
        'replaces': 'scripts/experimental/newton_solve.py:124, '
                    'scripts/experimental/newton_bt.py:272',
        'launches': newton_launches, 'max_abs_err': newton_abs_err,
        'ms': newton_ms, 'plain_ms': eager_ms, 'bound_ms': newton_bound_ms,
        'bound_by': newton_bound_by, 'library_ms': None}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
