"""A quick look at the new robots on the card: builds the Newton kernel for
nv = 18 (printing ptxas's registers and spills), its residency at the
shapes of spot, aliengo, mini_cheetah/flat, go1 and mini_cheetah/perlin,
then for go1, mini_cheetah and hyqreal1 on flat and perlin, 3 steps of
`step_batched` at B=4096 from the keyframe lowered 1 cm (on perlin first
raised 30 cm), each step's seconds, the peak device memory and each
narrow-phase group's ms (host clock around one call, synchronised).

    python3 scripts/torch_port/mesh_probe.py
"""

import subprocess
import time
from pathlib import Path
import sys

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from gym_quadruped_tpu_torch.models.model import load_model  # noqa: E402
from gym_quadruped_tpu_torch.ops import newton_fused as nf  # noqa: E402
from gym_quadruped_tpu_torch.physics import collision, engine, kinematics  # noqa: E402

B = 4096
SCENES = [('go1', 'flat'), ('mini_cheetah', 'flat'), ('hyqreal1', 'flat'),
          ('mini_cheetah', 'perlin'), ('hyqreal1', 'perlin'), ('go1', 'perlin')]


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True).stdout)
    _, secs, out = nf.build(18)
    print('build', secs)
    print('\n'.join(line for line in out.splitlines() if 'registers' in line or 'spill' in line))
    for ns, C in [(24, 32), (148, 0), (402, 0), (443, 32), (1058, 0)]:
        print('occupancy', ns, C, nf.occupancy(18, ns, C))
    for robot, scene in SCENES:
        dm = load_model(robot, scene, device='cuda')
        m = dm.m
        q = torch.as_tensor(np.asarray(m.key_qpos[0]), dtype=torch.float32,
                            device='cuda').expand(B, -1).clone()
        if scene == 'perlin':
            q[:, 2] += 0.3
        q[:, 2] -= 0.01
        v = torch.zeros(B, m.nv, device='cuda')
        u = torch.zeros(B, m.nu, device='cuda')
        torch.cuda.reset_peak_memory_stats()
        ws = None
        for i in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            q, v, fwd = engine.step_batched(dm, q, v, u, warmstart=ws)
            ws = fwd.qacc
            torch.cuda.synchronize()
            print(robot, scene, 'step', i, f'{time.perf_counter() - t:.3f}s', 'finite',
                  bool(torch.isfinite(q).all()))
        print('  peak GiB', torch.cuda.max_memory_allocated() / 2**30, 'ns', fwd.efc.J.shape[1],
              'C', fwd.efc.con_J.shape[1], 'active rows',
              float(fwd.efc.active.float().sum(1).mean()))
        kin = kinematics.fk(dm, q)
        for args in collision.group_args(dm, kin):
            torch.cuda.synchronize()
            t = time.perf_counter()
            collision._group(*args)
            torch.cuda.synchronize()
            t1, t2 = args[1]
            print('   ', collision._GEOM_NAMES[t1], collision._GEOM_NAMES[t2],
                  f'{(time.perf_counter() - t) * 1e3:.1f} ms')
        del fwd, q, v, ws, kin
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
