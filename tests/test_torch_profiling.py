"""The port's profiling utilities (utils/profiling.py) on the CPU, against the
JAX package's: RateMeter's median of laps on the same clock readings,
MetricsLogger's JSONL rows, and `trace` writing a trace file."""

import dataclasses
import json
from types import SimpleNamespace
from unittest import mock

import jax.numpy as jnp
import numpy as np
import torch

from gym_quadruped_tpu.utils import profiling as jprofiling
from gym_quadruped_tpu_torch.env import QuadrupedEnv
from gym_quadruped_tpu_torch.models.model import load_model
from gym_quadruped_tpu_torch.utils import profiling

# host clock readings: a lap starts and ends on two consecutive readings
CLOCK = [10.0, 10.5, 20.0, 20.25, 30.0, 31.0, 40.0, 40.125]
LAPS = [100, 100, 300, 50]


def _laps(module):
    meter = module.RateMeter(unit='env steps')
    assert np.isnan(meter.rate())
    with mock.patch.object(module, 'time', SimpleNamespace(perf_counter=iter(CLOCK).__next__)):
        for n in LAPS:
            with meter.lap(n=n):
                pass
    return meter


def test_rate_meter_matches_reference():
    meter, ref = _laps(profiling), _laps(jprofiling)
    assert meter.rate() == ref.rate() == np.median([200, 400, 300, 400]) == 350
    assert meter.total() == ref.total() == 550
    assert meter.laps() == [(100, 0.5), (100, 0.25), (300, 1.0), (50, 0.125)]
    meter.reset()
    assert np.isnan(meter.rate()) and meter.total() == 0


@dataclasses.dataclass
class _Out:
    x: torch.Tensor
    rest: tuple


def test_rate_meter_sync_returns_its_tree():
    tree = _Out(torch.ones(3), ({'a': torch.zeros(2)}, None, 1.5))
    assert profiling.RateMeter.sync(tree) is tree


def test_metrics_logger_rows_match_reference(tmp_path):
    rows = []
    for module, arr in ((profiling, torch.tensor), (jprofiling, jnp.asarray)):
        path = tmp_path / f'{module.__name__}.jsonl'
        with mock.patch.object(module, 'time', SimpleNamespace(time=iter([1.5, 2.5]).__next__)):
            with module.MetricsLogger(path) as logger:
                logger.log(0, reward=0.1, frac=np.float32(0.25), n=arr(3))
                logger.log(np.int64(7), mean=arr([2.0]))
        rows.append(path.read_text())
    assert rows[0] == rows[1]
    assert [json.loads(r) for r in rows[0].splitlines()] == [
        {'t': 1.5, 'step': 0, 'reward': 0.1, 'frac': 0.25, 'n': 3.0},
        {'t': 2.5, 'step': 7, 'mean': 2.0}]


def test_trace_writes_a_trace(tmp_path):
    env = QuadrupedEnv('spot', model=load_model('spot', 'flat', device='cpu'))
    state, _ = env.reset(torch.Generator().manual_seed(0), 2,
                         qpos=torch.as_tensor(env.model.m.key_qpos[0]))
    with profiling.trace(tmp_path / 'traces') as tr:
        env.step(state, torch.zeros(2, env.model.m.nu))
    assert tr.path.parent == tmp_path / 'traces' and tr.path.suffix == '.json'
    events = json.loads(tr.path.read_text())['traceEvents']
    names = {e.get('name') for e in events}
    assert {'smooth', 'newton', 'euler'} <= names
    assert {'smooth', 'newton'} <= {e.key for e in tr.profile.key_averages()}
