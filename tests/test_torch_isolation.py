"""The port imports neither JAX nor the JAX package.

In a fresh interpreter, a meta-path finder refuses `jax`, `jaxlib` and
`gym_quadruped_tpu` (and their submodules; `gym_quadruped_tpu_torch` is
allowed) and records every refusal with the file that asked. Then every
module of `gym_quadruped_tpu_torch` is imported (the example drives and
the live plotter among them, which run nothing at import), and
`chip_smoke` (the script's own imports with it). Nothing may have been refused, and none of
the refused names may be in `sys.modules`; nor may `mujoco`, which
`models.builder` and the replay tools import only when called (a GPU host need not
have it).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r'''
import importlib
import importlib.abc
import json
import pkgutil
import sys
import traceback

REFUSED = []


def _refused(name):
    top = name.split('.')[0]
    return top in ('jax', 'jaxlib', 'gym_quadruped_tpu')


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if _refused(name):
            frames = [f.filename for f in traceback.extract_stack()
                      if 'importlib' not in f.filename and '<frozen' not in f.filename]
            REFUSED.append([name, frames[-2] if len(frames) > 1 else '?'])
            raise ImportError(f'{name} is refused')
        return None


sys.meta_path.insert(0, Refuse())
import gym_quadruped_tpu_torch

modules = ['gym_quadruped_tpu_torch']
for info in pkgutil.walk_packages(gym_quadruped_tpu_torch.__path__, 'gym_quadruped_tpu_torch.'):
    modules.append(info.name)
errors = {}
for name in modules + ['chip_smoke']:
    try:
        importlib.import_module(name)
    except Exception as e:
        errors[name] = repr(e)
print(json.dumps({'modules': modules, 'refused': REFUSED, 'errors': errors,
                  'loaded': sorted(m for m in sys.modules if _refused(m)),
                  'mujoco': sorted(m for m in sys.modules if m.split('.')[0] == 'mujoco')}))
'''


def test_no_jax_and_no_reference_package():
    env = {**os.environ, 'PYTHONPATH': os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get('PYTHONPATH')] if p])}
    out = subprocess.run([sys.executable, '-c', SCRIPT], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    names = set(res['modules'])
    # the modules of this slice among them
    assert {'gym_quadruped_tpu_torch.env.gym_adapter', 'gym_quadruped_tpu_torch.parallel.mesh',
            'gym_quadruped_tpu_torch.parallel.distributed', 'gym_quadruped_tpu_torch.utils.legs',
            'gym_quadruped_tpu_torch.utils.symmetry', 'gym_quadruped_tpu_torch.models.builder',
            'gym_quadruped_tpu_torch.models.scenes', 'gym_quadruped_tpu_torch.utils.replay',
            'gym_quadruped_tpu_torch.utils.mujoco_visual',
            'gym_quadruped_tpu_torch.utils.live_plotter',
            'gym_quadruped_tpu_torch.examples.go2_mpc_locomotion',
            'gym_quadruped_tpu_torch.examples.aliengo_with_sensors',
            'gym_quadruped_tpu_torch.examples.aliengo_dataset',
            'gym_quadruped_tpu_torch.examples.dataset_reproduction'} <= names
    assert len(names) > 40
    assert res['errors'] == {}, res['errors']
    assert res['refused'] == [], res['refused']
    assert res['loaded'] == []
    assert res['mujoco'] == []
