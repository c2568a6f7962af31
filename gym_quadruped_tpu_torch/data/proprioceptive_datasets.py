"""Windowed supervised dataset over recorded trajectories.

Counterpart of gym_quadruped_tpu/data/proprioceptive_datasets.py, as a
`torch.utils.data.Dataset`: sliding (x_frames -> y_frames) windows over the
episodes of an HDF5 trajectory file (`utils/data/h5.py`), static or dynamic
framing, per-observable moments, subsets of episodes, and an optional load
of the observables into memory on a device. `as_batches` yields stacked
batches as tensors on the dataset's device, in the reference's
`as_jax_batches` order.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.data import Dataset

from gym_quadruped_tpu_torch.utils.data.h5 import H5Reader


def slices_from_traj_len(time_horizon: int, context_length: int, time_lag: int = 1) -> list:
    """Context-window slices over a trajectory of `time_horizon` steps.

    >>> [(s.start, s.stop) for s in slices_from_traj_len(10, 4, 2)]
    [(0, 4), (2, 6), (4, 8), (6, 10)]
    """
    return [slice(s, s + context_length)
            for s in range(0, time_horizon - context_length + 1, time_lag)]


class ProprioceptiveDataset(Dataset):
    """(x_frames -> y_frames) windowed pairs over H5 trajectories.

    mode 'static': x is the last x_frames and y the last y_frames of a
    window of max(x_frames, y_frames) steps; 'dynamic': x is the first
    x_frames and y the last y_frames of a window of x_frames + y_frames
    steps. Items are ({name: x (x_frames, ...)}, {name: y (y_frames, ...)}):
    tensors in `dtype` on `device` after `load_to_memory`, else the file's
    float64 arrays.
    """

    def __init__(self, data_file, x_obs_names, y_obs_names, x_frames: int = 1,
                 y_frames: int = 1, mode: str = 'static', load_to_memory: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        if x_frames <= 0 or y_frames <= 0:
            raise ValueError('X and Y need at least one frame each.')
        if mode not in ('static', 'dynamic'):
            raise ValueError(f"Mode {mode}: choose 'static' or 'dynamic'.")
        self.x_frames, self.y_frames = x_frames, y_frames
        self.h5file = H5Reader(data_file)
        self.x_obs_names = list(x_obs_names)
        self.y_obs_names = list(y_obs_names)
        for name in self.x_obs_names + self.y_obs_names:
            if name not in self.h5file.recordings:
                raise KeyError(f'Observation {name} not in {list(self.h5file.recordings)}')
        self.device = device
        self.dtype = dtype
        self.mean_vars = {}
        self._mode = mode
        self._load_to_memory = load_to_memory
        self._traj_lengths = {}
        self._indices = []
        self._compute_sample_indices()
        self._memory_data = None
        if load_to_memory:
            self._load_dataset_to_memory()

    def _compute_sample_indices(self):
        """(episode, window) of every sample, episode by episode. Every
        episode of a file has the datasets' time length."""
        rec = self.h5file.recordings
        n, T = self.h5file.n_trajectories, rec[self.x_obs_names[0]].shape[1]
        for name in self.x_obs_names + self.y_obs_names:
            if rec[name].shape[:2] != (n, T):
                raise ValueError(f'{name} of shape {rec[name].shape[:2]}, expected {(n, T)}')
        context = (max(self.x_frames, self.y_frames) if self._mode == 'static'
                   else self.x_frames + self.y_frames)
        windows = slices_from_traj_len(T, context, 1)
        for tid in range(n):
            self._indices.extend((tid, s) for s in windows)
            self._traj_lengths[tid] = T

    # --------------------------------------------------------------- access

    @property
    def n_trajectories(self):
        return len(self._traj_lengths)

    @property
    def raw_data(self):
        return self._memory_data if self._load_to_memory else self.h5file.recordings

    def _load_dataset_to_memory(self):
        """Each observable of every episode as one (episodes, T, ...) tensor
        in `dtype` on `device`: one read of the file and one copy per name."""
        self._memory_data = {
            name: torch.from_numpy(self.h5file.recordings[name][:]).to(self.device, self.dtype)
            for name in dict.fromkeys(self.x_obs_names + self.y_obs_names)}

    def shuffle(self, seed=None):
        """Shuffle the samples with a RandomState of `seed` (numpy's global
        state is left alone): the reference's order for the same seed."""
        np.random.RandomState(seed).shuffle(self._indices)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        tid, window = self._indices[idx]
        x_slice = slice(-self.x_frames, None) if self._mode == 'static' else slice(0, self.x_frames)
        y_slice = slice(-self.y_frames, None)
        x = {n: self.raw_data[n][tid][window][x_slice] for n in self.x_obs_names}
        y = {n: self.raw_data[n][tid][window][y_slice] for n in self.y_obs_names}
        return x, y

    # --------------------------------------------------------------- utilities

    def compute_obs_moments(self, obs_reps: dict | None = None):
        """Per-observable (mean, var) over the dataset's episodes, in float32
        numpy; for a name in `obs_reps` (group representations) the
        symmetry-aware moments of `symmetric_learning`, imported here."""
        tids = list(self._traj_lengths)
        for name in self.x_obs_names + self.y_obs_names:
            trajs = self.h5file.recordings[name][:][tids]
            data = trajs.reshape(-1, *trajs.shape[2:]).astype(np.float32)
            if obs_reps is not None and name in obs_reps:
                from symmetric_learning.nn.symmetric.stats import var_mean

                var, mean = var_mean(torch.tensor(data), obs_reps[name])
                self.mean_vars[name] = (mean, var)
            else:
                self.mean_vars[name] = (data.mean(0), data.var(0))
        return self.mean_vars

    def subset_dataset(self, trajectory_ids) -> 'ProprioceptiveDataset':
        """The dataset over the episodes `trajectory_ids` alone."""
        if len(trajectory_ids) == 0:
            raise ValueError('a subset needs at least one trajectory')
        sub = ProprioceptiveDataset(
            self.h5file.file_path, self.x_obs_names, self.y_obs_names, self.x_frames,
            self.y_frames, mode=self._mode, load_to_memory=self._load_to_memory,
            dtype=self.dtype, device=self.device)
        sub._indices = [i for i in self._indices if i[0] in trajectory_ids]
        for tid in list(sub._traj_lengths):
            if tid not in trajectory_ids:
                sub._traj_lengths.pop(tid)
        return sub

    def _tensor(self, x) -> torch.Tensor:
        return x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x), dtype=self.dtype, device=self.device)

    def as_batches(self, batch_size: int, seed: int = 0):
        """Stacked (x, y) batches of `batch_size` samples, tensors in
        `dtype` on `device`, in the order of a RandomState(seed)
        permutation (the reference's `as_jax_batches`); the last partial
        batch is dropped."""
        order = np.random.RandomState(seed).permutation(len(self))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [self[j] for j in order[i:i + batch_size]]
            x = {n: torch.stack([self._tensor(it[0][n]) for it in items]) for n in self.x_obs_names}
            y = {n: torch.stack([self._tensor(it[1][n]) for it in items]) for n in self.y_obs_names}
            yield x, y

    def __repr__(self):
        return f'{len(self._traj_lengths)} trajectories and {len(self)} total samples.'
