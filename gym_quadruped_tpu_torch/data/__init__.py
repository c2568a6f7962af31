"""Dataset adapters over the HDF5 trajectory store."""

from gym_quadruped_tpu_torch.data.proprioceptive_datasets import (
    ProprioceptiveDataset,
    slices_from_traj_len,
)

__all__ = ['ProprioceptiveDataset', 'slices_from_traj_len']
