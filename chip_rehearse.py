#!/usr/bin/env python3
"""CPU f32 run of chip_smoke.py's sensor phases (42-46), MPC phases (47-50),
mixed-batch phases (68-73) at a small batch, or the example drives' phase
81.

    python3 chip_rehearse.py [B]          # B=32 by default, ~6 min on 4 threads
    python3 chip_rehearse.py [B] --mpc    # phases 47-50, MPPI at K=B
    python3 chip_rehearse.py [B] --mixed  # phases 68-73, cfg5 at B envs
    python3 chip_rehearse.py --examples   # phase 81 (B=1 drives), ~2 min

It checks the phases' control flow, shapes and bars without a card, and
prints their lines with the same checks: the launch counts come from
counting the wrappers' calls (on CPU tensors they run their plain
versions), the kernel timings and host-sync counts are skipped, and every
time and memory figure it prints is the CPU's, not a device number. The
card's numbers come from `python3 chip_smoke.py` alone.
"""

from __future__ import annotations

import sys
import time
import types

import torch

import chip_smoke as cs
from gym_quadruped_tpu_torch.physics import engine


def stub_cuda():
    """Run chip_smoke's phases on the CPU: device 'cpu', the
    torch.cuda calls and the card-only measurements stubbed, each wrapper
    call of the two kernels counted as a launch."""
    cs.DEVICE = 'cpu'
    cs.smi = lambda: 'the CPU (no device numbers)'
    for name, fn in (('synchronize', lambda: None), ('reset_peak_memory_stats', lambda: None),
                     ('max_memory_allocated', lambda: 0), ('memory_allocated', lambda: 0),
                     ('current_stream', lambda: types.SimpleNamespace(cuda_stream=0))):
        setattr(torch.cuda, name, fn)
    cs.spd._library = lambda n: types.SimpleNamespace(gqt_spd_solve_f32=lambda *a: None)

    def host_ms(fn, launches=1, repeats=1):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    cs.median_ms = host_ms
    cs.range_ms = lambda run, name, n=1: (host_ms(run), None)
    cs.sync_count = lambda fn: (fn(), (0, None))[1]
    cs.newton_timing = lambda last, phase, rounding=False, cap=10: {}
    spd_solve, newton = engine.spd_solve_batched, cs.nf.solve_batched

    def spd_counted(*args, **kwargs):
        cs.spd.launches += 1
        return spd_solve(*args, **kwargs)

    def newton_counted(*args, **kwargs):
        cs.nf.launches += 1
        return newton(*args, **kwargs)

    engine.spd_solve_batched = spd_counted
    cs.nf.solve_batched = newton_counted


def main():
    try:
        phases()
    finally:
        cs.stop_workers()


def phases():
    args = [a for a in sys.argv[1:] if a not in ('--mpc', '--mixed', '--examples')]
    B = int(args[0]) if args else 32
    torch.set_num_threads(4)
    stub_cuda()
    t0 = time.perf_counter()
    if '--mpc' in sys.argv:
        warm_rate = cs.mpc_solves(B=B)
        run = cs.mpc_closed_loop(warm_rate, B=B)
        cs.mpc_card_against_cpu(run)
        cs.mppi_solves(K=B)
        cs.drain()
        print(f'phases 47-50 on the CPU at B={B}: {time.perf_counter() - t0:.1f} s')
        return
    if '--examples' in sys.argv:
        cs.example_phases({}, {})
        print(f'phase 81 on the CPU: {time.perf_counter() - t0:.1f} s')
        return
    if '--mixed' in sys.argv:
        run = cs.cfg5_main_path(B=B)
        bar = cs.cfg5_against_homogeneous(run)
        cs.cfg5_card_against_cpu(run)
        cs.cfg5_resume(run, bar, B=B)
        cs.cfg5_record(run)
        cs.cfg5_profile(run)
        cs.drain()
        print(f'phases 68-73 on the CPU at B={B}: {time.perf_counter() - t0:.1f} s')
        return
    run = cs.sensors_main_path(B=B)
    cs.sensors_card_against_cpu(run)
    terrain = cs.terrain_sensors(B=B)
    cs.camera_renders({'flat': (run['env'].model, run['state']),
                       'perlin': terrain['perlin_state']})
    cs.camera_env(B=max(B // 2, 1))
    cs.drain()
    print(f'phases 42-46 on the CPU at B={B}: {time.perf_counter() - t0:.1f} s')


if __name__ == '__main__':
    main()
