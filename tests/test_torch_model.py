"""The port's model loading and static tables against the JAX package's.

Every compiled archive loads to the same arrays through the port's
`Model.load`, `load_model` and `from_arrays` (the function that carries a JAX
`Model` across); the slot and constraint layouts agree for spot/flat and
go2/flat.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models import builder as jbuilder
from gym_quadruped_tpu.models.model import Model as JModel
from gym_quadruped_tpu.physics import collision as jcol
from gym_quadruped_tpu.physics import constraints as jcon
from gym_quadruped_tpu_torch.models import model as pmodel
from gym_quadruped_tpu_torch.physics import collision as pcol
from gym_quadruped_tpu_torch.physics import constraints as pcon

ARCHIVES = ['aliengo-flat', 'aliengo-perlin', 'b2-flat', 'b2-perlin', 'go1-flat',
            'go1-perlin', 'go2-flat', 'go2-perlin', 'go2-ramp', 'go2-slippery',
            'go2-stairs', 'hyqreal1-flat', 'hyqreal1-perlin', 'hyqreal2-flat',
            'hyqreal2-perlin', 'hyqreal2-random_boxes', 'mini_cheetah-flat',
            'mini_cheetah-perlin', 'spot-flat', 'spot-perlin']


def _fields(m):
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}


def _assert_same_model(jm, pm):
    assert [f.name for f in dataclasses.fields(jm)] == \
        [f.name for f in dataclasses.fields(pm)]
    for name, a in _fields(jm).items():
        b = getattr(pm, name)
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray) and b.dtype == a.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            assert type(b) is type(a) and b == a, name


def test_archive_list_is_complete():
    assert sorted(p.stem for p in pmodel.COMPILED_DIR.glob('*.npz')) == ARCHIVES


@pytest.mark.parametrize('name', ARCHIVES)
def test_archive_loads_equal(name):
    robot, scene = name.split('-')
    path = pmodel.COMPILED_DIR / f'{name}.npz'
    jm = JModel.load(path)
    _assert_same_model(jm, pmodel.Model.load(path))
    _assert_same_model(jm, pmodel.from_arrays(_fields(jm)))

    dm = pmodel.load_model(robot, scene, device='cpu', dtype=torch.float64)
    _assert_same_model(jm, dm.m)
    for fname, a in _fields(jm).items():
        if isinstance(a, np.ndarray) and a.dtype.kind == 'f':
            t = getattr(dm, fname)
            assert t.dtype == torch.float64 and t.device.type == 'cpu'
            np.testing.assert_array_equal(t.numpy(), a, err_msg=fname)
    dm32 = pmodel.to_device(dm.m, 'cpu', torch.float32)
    assert dm32.body_mass.dtype == torch.float32


def test_load_model_timestep_override_and_missing_archive():
    jm = jbuilder.load_model('spot', 'flat', sim_dt=0.001)
    dm = pmodel.load_model('spot', 'flat', sim_dt=0.001, device='cpu')
    assert dm.m.timestep == jm.timestep == 0.001 and dm.timestep == 0.001
    with pytest.raises(FileNotFoundError):
        pmodel.load_model('spot', 'no_such_scene', device='cpu')


@pytest.mark.parametrize('name', ['spot-flat', 'go2-flat'])
def test_static_tables_equal(name):
    path = pmodel.COMPILED_DIR / f'{name}.npz'
    jm = JModel.load(path)
    pm = pmodel.from_arrays(_fields(jm))

    jspecs, pspecs = jcol.contact_layout(jm), pcol.contact_layout(pm)
    assert [dataclasses.astuple(s) for s in pspecs] == \
        [dataclasses.astuple(s) for s in jspecs]
    assert pcol.total_contact_slots(pm) == jcol.total_contact_slots(jm)

    jlay, play = jcon.constraint_layout(jm), pcon.constraint_layout(pm)
    for f in dataclasses.fields(jlay):
        a, b = getattr(jlay, f.name), getattr(play, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=f.name)
            assert b.dtype == a.dtype, f.name
        else:
            assert b == a, f.name
    np.testing.assert_array_equal(pcon.con_mask_table(pm, play),
                                  jcon.con_mask_table(jm, jlay))
