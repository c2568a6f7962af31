"""Morphological-symmetry group representations of the observables.

Counterpart of gym_quadruped_tpu/utils/symmetry.py (the reference's optional
`morpho_symm` integration, utils/quadruped_utils.py:328-427): each
observable name maps to the group representation acting on it (vectors,
pseudo-vectors, joint-space representations, leg permutations, the
Kronecker flat SO(3)), for equivariant learning and data augmentation.
`morpho_symm` and `escnn` are optional extras: their ImportError is raised
when the representations are asked for, so nothing else depends on them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def configure_observation_space_representations(
        robot_name: str, obs_names: Sequence[str], **load_symm_kwargs) -> dict:
    """{obs_name: escnn Representation} of each observable asked for."""
    try:
        from morpho_symm.utils.rep_theory_utils import escnn_representation_form_mapping
        from morpho_symm.utils.robot_utils import load_symmetric_system
    except ImportError as e:
        raise ImportError('morpho_symm package is required to configure '
                          'observation group representations') from e

    G = load_symmetric_system(robot_name=robot_name, return_robot=False, **load_symm_kwargs)
    try:
        rep_Q_js = G.representations['Q_js']
        rep_TqQ_js = G.representations['TqQ_js']
        rep_Rd = G.representations['R3']
        rep_Rd_pseudo = G.representations['R3_pseudo']
        rep_euler_xyz = G.representations['R3_pseudo']
        rep_kin_three = G.representations['kin_chain']  # leg permutations
        rep_Rd_on_limbs = rep_kin_three.tensor(rep_Rd)
        rep_Rd_on_limbs.name = 'Rd_on_limbs'
        rep_Rd_pseudo_on_limbs = rep_kin_three.tensor(rep_Rd_pseudo)
        rep_Rd_pseudo_on_limbs.name = 'Rd_pseudo_on_limbs'
        # flattened SO(3): R -> rep(g) R rep(g)^-1 as a Kronecker product
        rep_SO3_flat = escnn_representation_form_mapping(
            G, {h: np.kron(rep_Rd(h), rep_Rd(~h).T) for h in G.elements})
        rep_SO3_flat.name = 'SO3_flat'
        rep_z = escnn_representation_form_mapping(
            G, {g: rep_Rd(g)[2:3, 2:3] for g in G.elements}, name='base_z')
    except KeyError as e:
        raise KeyError(
            f'Group rep for {e.args[0]} missing from robot {robot_name} '
            f'configuration. Available: {list(G.representations.keys())}') from e

    obs_reps = dict.fromkeys(obs_names)
    for name in obs_names:
        base = name.split(':')[0]
        if name in ('qpos', 'base_ori_quat_wxyz'):
            continue  # quaternions lack a left-group action
        elif name == 'qvel':
            obs_reps[name] = rep_Rd + rep_Rd_pseudo + rep_TqQ_js
        elif name in ('tau_ctrl_setpoint', 'action'):
            obs_reps[name] = rep_TqQ_js
        elif name == 'qpos_js':
            obs_reps[name] = rep_Q_js
        elif name == 'qvel_js':
            obs_reps[name] = rep_TqQ_js
        elif name == 'base_pos':
            obs_reps[name] = rep_Rd
        elif name == 'base_pos_z':
            obs_reps[name] = rep_z
        elif base in ('base_lin_vel', 'base_lin_vel_err', 'base_lin_acc'):
            obs_reps[name] = rep_Rd
        elif base in ('base_ang_vel', 'base_ang_vel_err'):
            obs_reps[name] = rep_Rd_pseudo
        elif base == 'base_ori_euler_xyz':
            obs_reps[name] = rep_euler_xyz
        elif name == 'base_ori_SO3':
            obs_reps[name] = rep_SO3_flat
        elif base.startswith('feet_pos') or base.startswith('feet_vel'):
            obs_reps[name] = rep_Rd_on_limbs
        elif name == 'contact_state':
            obs_reps[name] = rep_kin_three
        elif base == 'contact_forces':
            obs_reps[name] = rep_Rd_on_limbs
        elif base == 'gravity_vector' or base == 'imu_acc':
            obs_reps[name] = rep_Rd
        elif base == 'imu_gyro':
            obs_reps[name] = rep_Rd_pseudo
        elif name in ('work', 'kinetic_energy', 'reward'):
            obs_reps[name] = G.trivial_representation
        else:
            from gym_quadruped_tpu_torch.env.observables import ALL_OBS

            raise ValueError(f'Invalid observation name: {name}, available: {ALL_OBS}')
    return obs_reps


def augment_obs_data(obs_data: dict, obs_reps: dict, fix_base: bool = False) -> dict:
    """Every group element's image of a dict of observation arrays (numpy).

    The reference's augmentation (examples/dataset_reproduction.py:26-58):
    for each non-identity element g, each observable with a representation
    maps to `rep(g) @ obs`; the base quaternion inside `qpos` transforms by
    conjugating its rotation matrix with the R3 representation. Any
    escnn-like group will do (duck-typed: `rep.group`, `group.identity`,
    `group.elements`, `group.representations['R3']`, `rep(g) -> matrix`).

    MuJoCo's qpos quaternions are wxyz (scalar first). The reference's
    example hands them to scipy as xyzw and so rotates them wrongly; here
    they are read as wxyz, through `utils.maths.quat_to_mat` and
    `mat_to_quat`.

    Args:
      obs_data: {obs_name: array (..., dim)}.
      obs_reps: {obs_name: Representation or None}, as
        `configure_observation_space_representations` gives them.
      fix_base: pin the base xy to a constant first (for side-by-side
        replays).

    Returns:
      {obs_name: {group_element: array or None}}; the identity maps to the
      input data.
    """
    from gym_quadruped_tpu_torch.utils import maths

    assert len(obs_data) > 0
    rep0 = next(r for r in obs_reps.values() if r is not None)
    G = rep0.group
    obs_data = {k: np.array(v) for k, v in obs_data.items()}
    if fix_base and 'base_pos' in obs_data:
        base_xy = np.array(obs_data['base_pos'][..., :2])
        obs_data['base_pos'][..., :2] = 1.0
        if 'qpos' in obs_data:
            obs_data['qpos'][..., :2] = 1.0
        if 'feet_pos' in obs_data:
            for leg in range(4):
                sl = slice(3 * leg, 3 * leg + 2)
                obs_data['feet_pos'][..., sl] -= base_xy - 1.0

    out = {name: {G.identity: data} for name, data in obs_data.items()}
    for g in G.elements[1:]:
        for name, data in obs_data.items():
            rep = obs_reps.get(name)
            out[name][g] = None if rep is None else np.einsum('ij,...j->...i', rep(g), data)

    # the base quaternion (qpos[..., 3:7], wxyz): conjugate its rotation matrix
    reps = getattr(G, 'representations', {})
    if 'qpos' in out and 'R3' in reps:
        rep_R3 = reps['R3']
        q_wxyz = out['qpos'][G.identity][..., 3:7]
        R = maths.quat_to_mat(torch.as_tensor(q_wxyz)).numpy()
        for g in G.elements[1:]:
            if out['qpos'][g] is None:
                continue
            M = rep_R3(g)
            gR = np.einsum('ij,...jk,lk->...il', M, R, M)
            out['qpos'][g][..., 3:7] = maths.mat_to_quat(torch.as_tensor(gR)).numpy()
    return out
