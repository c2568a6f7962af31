"""Profiling and host metrics.

Counterpart of gym_quadruped_tpu/utils/profiling.py:

- `trace(log_dir)`: a context manager around `torch.profiler.profile`
  (the host's operators and, with a card, its kernels) that writes a
  Chrome trace JSON under `log_dir` (chrome://tracing or Perfetto open it)
  and yields a `Trace` whose `profile` gives `key_averages()`.
- `RateMeter`: steps/s (or solves/s) over laps of completed work,
  synchronised with the card before each lap ends, reported as the median
  of the laps so that one slow lap (a first build, a busy host) does not
  set it.
- `MetricsLogger`: an append-only JSONL sink of scalar metrics, rows
  {"t": <unix s>, "step": <int>, "<name>": <float>, ...}, as the
  reference writes them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from gym_quadruped_tpu_torch.utils.tree import leaves_with_path

__all__ = ['trace', 'Trace', 'RateMeter', 'MetricsLogger']


@dataclasses.dataclass
class Trace:
    """What `trace` yields: the profiler, and the trace file it writes when
    the block ends."""

    profile: torch.profiler.profile
    path: Path


@contextlib.contextmanager
def trace(log_dir):
    """Profile the enclosed block; on its end (the card synchronised first)
    write the trace to `log_dir/trace-<pid>-<ns>.json`."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    out = Trace(prof, log_dir / f'trace-{os.getpid()}-{time.time_ns()}.json')
    prof.start()
    try:
        yield out
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(out.path))


class RateMeter:
    """Median-of-laps throughput counter.

    >>> meter = RateMeter(unit='env steps')
    >>> for _ in range(5):
    ...     with meter.lap(n=batch * n_steps):
    ...         out = step_n(state)
    ...         meter.sync(out)          # the card done before the lap ends
    >>> meter.rate()                     # median env steps/s over the laps
    """

    def __init__(self, unit: str = 'steps'):
        self.unit = unit
        self._laps: list[tuple[int, float]] = []

    @contextlib.contextmanager
    def lap(self, n: int):
        """Time the enclosed block as one lap of `n` units of work."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self._laps.append((int(n), time.perf_counter() - t0))

    @staticmethod
    def sync(tree):
        """Wait until the work behind `tree`'s tensors is done: synchronise
        the current stream of each card they are on. Call on the lap's
        outputs: kernels run after the launch returns, and without it the
        lap measures the launches, not the work."""
        for device in {x.device for _, x in leaves_with_path(tree) if x.is_cuda}:
            torch.cuda.current_stream(device).synchronize()
        return tree

    def laps(self) -> list:
        """[(units, seconds)] of every lap so far."""
        return list(self._laps)

    def rate(self) -> float:
        """Median per-lap rate (units / second); NaN before any lap."""
        rates = [n / dt for n, dt in self._laps if dt > 0]
        return float(np.median(rates)) if rates else float('nan')

    def total(self) -> int:
        return sum(n for n, _ in self._laps)

    def reset(self) -> None:
        self._laps.clear()


class MetricsLogger:
    """Append-only JSONL scalar sink: one row per `log` call.

    Takes Python and numpy scalars and one-element tensors on any device
    (each read back with one copy to the host: pass means and fractions,
    not whole tensors)."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = self.path.open('a', buffering=1)

    def log(self, step: int, **metrics) -> None:
        row = {'t': time.time(), 'step': int(step)}
        for k, v in metrics.items():
            row[k] = (float(v.reshape(()).item()) if isinstance(v, torch.Tensor)
                      else float(np.asarray(v).reshape(())))
        self._f.write(json.dumps(row) + '\n')

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
