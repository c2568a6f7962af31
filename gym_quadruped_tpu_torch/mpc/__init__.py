"""Centroidal MPC stack: gait, SRB model, condensed-QP ADMM, torque mapping;
and MPPI over the full physics."""

from gym_quadruped_tpu_torch.mpc.centroidal import CentroidalParams
from gym_quadruped_tpu_torch.mpc.controller import CentroidalMPC, MPCConfig
from gym_quadruped_tpu_torch.mpc.gait import GaitConfig
from gym_quadruped_tpu_torch.mpc.mppi import MPPI, MPPIConfig, velocity_tracking_cost
from gym_quadruped_tpu_torch.mpc.qp import MPCWeights

__all__ = ['CentroidalMPC', 'MPCConfig', 'CentroidalParams', 'GaitConfig',
           'MPCWeights', 'MPPI', 'MPPIConfig', 'velocity_tracking_cost']
