"""The port's live plotter (utils/live_plotter.py) against the JAX package's.

* The registry: every predefined figure (with its defaults, custom legs
  and joints, a window size, disabled) and a free-form `create` make the
  same figures in both packages: names, titles, y limits, rows, cols,
  window sizes.
* `send_data` puts Python floats on the queue, never a tensor, and drops
  a frame when the queue is full.
* The child's tick, driven in this process under matplotlib's Agg backend
  (`plt.show` and `FuncAnimation` patched to call the tick, each figure's
  queue a thread queue), leaves the same line data in both packages, fed
  the same values (tensors to the port, arrays and floats to the
  reference), and closes the figure at the end of the stream.
* A real child process in sink mode (no matplotlib in it), fed tensors,
  drains its queue and exits with code 0 when closed, within 10 s.
"""

import queue
import signal
import sys
import time

import numpy as np
import pytest
import torch

from gym_quadruped_tpu.utils import live_plotter as jlp
from gym_quadruped_tpu_torch.utils import live_plotter as plp

FIELDS = ('figure_name', 'num_subplots', 'subplot_titles', 'nrows', 'ncols', 'window_size',
          'y_limits', 'plots_per_ax')


def _figures(mod):
    """Every figure the registry makes, as {name: {field: value}}, with the
    predefined methods' returns."""
    p = mod.MujocoPlotter()
    returns = [p.torque_plot(), p.jointpos_plot(legs=['FL', 'RR'], window_size=20),
               p.jointvel_plot(joint_names=['HAA', 'KFE']), p.footcontact_plot(window_size=30),
               p.linacc_plot(), p.angvel_plot(window_size=10), p.torque_plot(enable=False)]
    p.create('Custom', ['a', 'b', 'c', 'd'], y_limits=[(-2, 5)], rows=2, cols=2,
             window_size=7, plots_per_ax=2)
    p.create('Free', ['only'])
    off = mod.MujocoPlotter(enable=False)
    off.torque_plot()
    off.linacc_plot()
    return returns, {name: {f: getattr(fig, f) for f in FIELDS} for name, fig in
                     p.plots.items()}, off.plots


def test_registry_matches():
    got, want = _figures(plp), _figures(jlp)
    assert got == want
    returns, figures, off = got
    assert list(figures) == plp.MujocoPlotter.PREDEFINED + ['Custom', 'Free'] and off == {}
    assert figures['Torque']['subplot_titles'][:2] == ['Torque FL_HAA', 'Torque FL_HFE']
    assert figures['JointPos']['nrows'] == 2 and figures['Custom']['y_limits'] == [(-2, 5)] * 4
    assert returns[0] == (plp.MujocoPlotter.LEGS, plp.MujocoPlotter.JOINTS)


def test_send_data_floats_and_drops():
    fig = plp.MujocoPlotter().create('F', ['x', 'y', 'z'], rows=1, cols=3)
    fig._queue = queue.Queue(maxsize=4)
    fig.send_data({'x': torch.tensor([1.5, 2.0], dtype=torch.float32),
                   'y': torch.tensor(3.25, dtype=torch.float64),
                   'z': torch.tensor([1, 0], dtype=torch.int32), 'w': [4.0]})
    item = fig._queue.get_nowait()
    assert item == {'x': [1.5, 2.0], 'y': 3.25, 'z': [1.0, 0.0], 'w': [4.0]}
    assert all(type(v) is float for v in item['x'] + item['z'] + [item['y']])
    for i in range(6):              # the queue takes 4: the rest are dropped
        fig.send_data({'x': torch.tensor([float(i)])})
    assert fig._queue.qsize() == 4


FRAMES = [{'Torque FL_HAA': [1.0, 2.0, 3.0], 'Torque RR_KFE': 4.5},
          {'Torque FL_HAA': np.array([-7.25]), 'Unknown': [9.0]},
          {'Torque RR_KFE': np.arange(12.0), 'Torque FR_HFE': np.float32(0.5)}]


def _tick_lines(mod, monkeypatch, tensors):
    """The figure's line data after one tick over FRAMES, and the tick's
    return at the end of the stream."""
    import matplotlib
    import matplotlib.animation
    import matplotlib.pyplot as plt

    matplotlib.use('Agg')
    ticks = []
    monkeypatch.setattr(signal, 'signal', lambda *a: None)
    monkeypatch.setattr(plt, 'show', lambda *a, **k: None)
    monkeypatch.setattr(matplotlib.animation, 'FuncAnimation',
                        lambda fig, tick, **kw: ticks.append(tick))
    p = mod.MujocoPlotter()
    p.torque_plot(window_size=8)
    fig = p.plots['Torque']
    fig._queue = queue.Queue(maxsize=256)
    for frame in FRAMES:
        p.update('Torque', {k: torch.as_tensor(np.asarray(v)) if tensors else v
                            for k, v in frame.items()})
    fig._run()
    lines = ticks[0](0)
    data = {line.axes.get_title(): np.asarray(line.get_ydata(), np.float64) for line in lines}
    fig._queue.put(None)
    end = ticks[0](1)
    plt.close('all')
    return data, end


def test_tick_matches(monkeypatch):
    got, end = _tick_lines(plp, monkeypatch, tensors=True)
    want, ref_end = _tick_lines(jlp, monkeypatch, tensors=False)
    assert end == ref_end == []
    assert list(got) == list(want) and len(got) == 12
    for title in want:
        np.testing.assert_array_equal(got[title], want[title], err_msg=title)
    np.testing.assert_array_equal(got['Torque FL_HAA'], [0, 0, 0, 0, 1, 2, 3, -7.25])
    np.testing.assert_array_equal(got['Torque RR_KFE'], np.arange(4.0, 12.0))
    np.testing.assert_array_equal(got['Torque FR_HFE'], [0] * 7 + [0.5])


def test_child_process_sink(monkeypatch):
    # the forked children find no matplotlib: they drain their queues
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    p = plp.MujocoPlotter()
    p.torque_plot()
    p.footcontact_plot()
    p.start()
    procs = [fig._proc for fig in p.plots.values()]
    assert all(proc.is_alive() for proc in procs)
    gen = torch.Generator().manual_seed(0)
    for _ in range(300):            # more than a queue holds: the sink keeps up or drops
        tau = torch.randn(4, 3, generator=gen)
        p.update('Torque', {f'Torque {leg}_{j}': tau[i, k] for i, leg in enumerate(p.LEGS)
                            for k, j in enumerate(p.JOINTS)})
        p.update('FootContacts', {f'FootContacts {leg}': torch.tensor([1.0, 0.0])
                                  for leg in p.LEGS})
    t0 = time.perf_counter()
    p.close()
    closed = time.perf_counter() - t0
    for proc in procs:
        proc.join(timeout=10.0)
    assert [proc.exitcode for proc in procs] == [0, 0], closed
    assert closed < 10.0
