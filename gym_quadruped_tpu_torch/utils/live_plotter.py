"""Live plotting of simulation signals in a separate process.

The reference's live plotter (utils/live_plotter.py:16-458) on the port's
tensors: `MujocoPlotter` offers the predefined figures (Torque, JointPos,
JointVel, FootContacts, LinAcc, AngVel) and free-form figures;
`MultiLivePlotter` runs in its own `multiprocessing.Process`, fed through an
`mp.Queue` that drops frames when full, and animates with matplotlib's
`FuncAnimation`, so plotting never blocks the batched simulation. Feed it
host-side slices (env 0 of the batch, say) at any rate, as
{subplot_title: [values...]} dicts.

Tensors, on any device, become Python floats on the sender's side
(`send_data`): the child process never receives a tensor, so a child forked
after CUDA started never touches the card.

Where matplotlib or a figure cannot be had (a headless host), the child
only drains the queue (sink mode), so instrumented scripts run unchanged.
"""

from __future__ import annotations

import multiprocessing as mp
import signal
from collections import deque

import torch


class MujocoPlotter:
    """Factory and registry of live plot figures (reference live_plotter.py:16-226)."""

    LEGS = ['FL', 'FR', 'RL', 'RR']
    JOINTS = ['HAA', 'HFE', 'KFE']
    AXES3 = ['X', 'Y', 'Z']
    PREDEFINED = ['Torque', 'JointPos', 'JointVel', 'FootContacts', 'LinAcc', 'AngVel']

    def __init__(self, enable: bool = True):
        self.plots: dict = {}
        self.all_plot_enable = enable

    def create(self, figure_name: str, subplot_titles: list, y_limits=None,
               rows: int = 1, cols: int = 1, window_size: int = 50,
               plots_per_ax: int = 1):
        y_limits = y_limits or [(-1, 1)]
        self.plots[figure_name] = MultiLivePlotter(
            figure_name=figure_name, num_subplots=rows * cols,
            subplot_titles=subplot_titles, nrows=rows, ncols=cols,
            window_size=window_size, y_limits=list(y_limits) * (rows * cols),
            plots_per_ax=plots_per_ax)
        return self.plots[figure_name]

    def _grid_plot(self, name, y_limit, row_names, col_names, window_size):
        titles = [f'{name} {r}_{c}' for r in row_names for c in col_names]
        self.create(name, titles, y_limits=y_limit, rows=len(row_names),
                    cols=len(col_names), window_size=window_size)
        return row_names, col_names

    def torque_plot(self, legs=None, joint_names=None, window_size=50, enable=True):
        if enable and self.all_plot_enable:
            return self._grid_plot('Torque', [(-120, 120)], legs or self.LEGS,
                                   joint_names or self.JOINTS, window_size)

    def jointpos_plot(self, legs=None, joint_names=None, window_size=50, enable=True):
        if enable and self.all_plot_enable:
            return self._grid_plot('JointPos', [(-3.5, 3.5)], legs or self.LEGS,
                                   joint_names or self.JOINTS, window_size)

    def jointvel_plot(self, legs=None, joint_names=None, window_size=50, enable=True):
        if enable and self.all_plot_enable:
            return self._grid_plot('JointVel', [(-15, 15)], legs or self.LEGS,
                                   joint_names or self.JOINTS, window_size)

    def footcontact_plot(self, legs=None, window_size=50, enable=True):
        if enable and self.all_plot_enable:
            titles = [f'FootContacts {leg}' for leg in (legs or self.LEGS)]
            self.create('FootContacts', titles, y_limits=[(-0.1, 1.1)],
                        rows=2, cols=2, window_size=window_size)

    def linacc_plot(self, window_size=50, enable=True):
        if enable and self.all_plot_enable:
            titles = [f'LinAcc {a}' for a in self.AXES3]
            self.create('LinAcc', titles, y_limits=[(-30, 30)], rows=1, cols=3,
                        window_size=window_size)

    def angvel_plot(self, window_size=50, enable=True):
        if enable and self.all_plot_enable:
            titles = [f'AngVel {a}' for a in self.AXES3]
            self.create('AngVel', titles, y_limits=[(-10, 10)], rows=1, cols=3,
                        window_size=window_size)

    def start(self):
        for p in self.plots.values():
            p.start()

    def update(self, figure_name: str, data: dict):
        """Send {subplot_title: values} to a figure (non-blocking)."""
        if figure_name in self.plots:
            self.plots[figure_name].send_data(data)

    def close(self):
        for p in self.plots.values():
            p.close()


def _floats(values):
    """A tensor's values as Python floats (a float for a 0-d tensor); any
    other value as it is."""
    if isinstance(values, torch.Tensor):
        return values.detach().to('cpu', torch.float64).tolist()
    return values


class MultiLivePlotter:
    """Multi-subplot streaming plotter in a separate process (reference
    live_plotter.py:228-458: mp.Process, mp.Queue, FuncAnimation)."""

    def __init__(self, figure_name: str, num_subplots: int, subplot_titles: list,
                 nrows: int, ncols: int, window_size: int = 50, y_limits=None,
                 plots_per_ax: int = 1):
        self.figure_name = figure_name
        self.num_subplots = num_subplots
        self.subplot_titles = list(subplot_titles)
        self.nrows, self.ncols = nrows, ncols
        self.window_size = window_size
        self.y_limits = y_limits or [(-1, 1)] * num_subplots
        self.plots_per_ax = plots_per_ax
        self._queue: mp.Queue = mp.Queue(maxsize=256)
        self._proc: mp.Process | None = None

    def start(self):
        self._proc = mp.Process(target=self._run, daemon=True)
        self._proc.start()

    def send_data(self, data: dict):
        """Non-blocking enqueue of {title: values}, tensors as Python floats;
        drops the frame when the plotter lags."""
        try:
            self._queue.put_nowait({title: _floats(v) for title, v in data.items()})
        except Exception:
            pass

    def close(self):
        if self._proc is not None and self._proc.is_alive():
            self._queue.put(None)
            self._proc.join(timeout=2.0)
            if self._proc.is_alive():
                self._proc.terminate()

    # ------------------------------------------------------------- process side

    def _run(self):
        signal.signal(signal.SIGTERM, lambda *_: exit(0))
        try:
            import matplotlib  # noqa: F401
            import matplotlib.pyplot as plt
            from matplotlib.animation import FuncAnimation
        except Exception:
            self._sink()
            return
        try:
            fig, axes = plt.subplots(self.nrows, self.ncols, num=self.figure_name,
                                     squeeze=False)
        except Exception:
            self._sink()
            return

        buffers = {t: deque([0.0] * self.window_size, maxlen=self.window_size)
                   for t in self.subplot_titles}
        lines = {}
        for i, title in enumerate(self.subplot_titles):
            ax = axes[i // self.ncols][i % self.ncols]
            ax.set_title(title, fontsize=8)
            ax.set_xlim(0, self.window_size)
            ax.set_ylim(*self.y_limits[i])
            (lines[title],) = ax.plot(range(self.window_size), buffers[title])

        def tick(_):
            while not self._queue.empty():
                item = self._queue.get_nowait()
                if item is None:
                    plt.close(fig)
                    return []
                for title, vals in item.items():
                    if title in buffers:
                        v = vals if hasattr(vals, '__len__') else [vals]
                        buffers[title].extend(v)
            for title, line in lines.items():
                line.set_ydata(list(buffers[title]))
            return list(lines.values())

        _anim = FuncAnimation(fig, tick, interval=100, cache_frame_data=False)  # noqa: F841
        plt.show()

    def _sink(self):
        """Headless fallback: drain the queue so senders never block."""
        while True:
            item = self._queue.get()
            if item is None:
                return
