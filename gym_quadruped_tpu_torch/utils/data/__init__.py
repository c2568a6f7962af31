"""Data I/O: the HDF5 trajectory store, in the reference's schema."""

from gym_quadruped_tpu_torch.utils.data.h5 import (
    H5Reader,
    H5Writer,
    load_dict_from_h5,
    save_dict_to_h5,
)

__all__ = ['H5Writer', 'H5Reader', 'save_dict_to_h5', 'load_dict_from_h5']
