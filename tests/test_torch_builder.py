"""The port's MJCF model compiler (`models/builder.py`, `models/scenes.py`)
against the JAX package's, on the CPU.

The repository ships no robot MJCF, so the robot is the joint tree of
scripts/torch_port/make_joint_tree.py, written without its floor as go2's
robot file into a temporary robot_model directory that both packages find
through $GYM_QUADRUPED_ASSETS (`write_robot_assets`). Both packages build
from the same files, in the same process, with their build caches cleared
around each test.

* Each of the 7 scenes: the composed MJCF text, the terrain limits and
  `build_model('go2', scene)` equal the reference's, every `Model` field
  exactly (`np.array_equal`, dtypes and names included).
* A per-robot `scene_rough.xml` beside the robot file builds through
  `make_from_reference_xml` as the reference's does; a geom attribute the
  importer does not know raises in both packages.
* A variant whose tail is an inline convex mesh: `_has_collidable_meshes`
  keeps the mesh, and the hull fields (`mesh_vert`, `mesh_vertnum`,
  `mesh_nbr`, `geom_dataid`) equal the reference's with the rest.
* The fixtures: `extract_model` on the tree's MJCF rebuilds the committed
  `jointtree-flat.npz`, and `build_model` the committed
  `jointtree-random_pyramids.npz`, array by array; `load_model` builds a
  scene that has no archive.
* Importing `models.builder` imports no `mujoco`.
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
import tempfile
import warnings
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models import builder as jbuilder
from gym_quadruped_tpu.models import scenes as jscenes
from gym_quadruped_tpu_torch.models import builder as pbuilder
from gym_quadruped_tpu_torch.models import model as pmodel
from gym_quadruped_tpu_torch.models import scenes as pscenes
from gym_quadruped_tpu_torch.models.model import JOINT_TREE, JOINT_TREE_PYRAMIDS, Model

ROOT = Path(__file__).resolve().parents[1]
SCENES = pscenes.STATIC_SCENES + pscenes.PROCEDURAL_SCENES
# a convex hull in place of the tail's capsule: 8 vertices, from the ball
# joint back to the tip, narrowing
TAIL_HULL = ('0 -0.015 -0.015  0 0.015 -0.015  0 -0.015 0.015  0 0.015 0.015  '
             '-0.32 -0.01 0.07  -0.32 0.01 0.07  -0.32 -0.01 0.09  -0.32 0.01 0.09')
ROUGH = """<mujoco model="rough">
  <worldbody>
    <geom name="floor" type="plane" size="0 0 0.05"/>
    <geom name="b0" type="box" pos="1.0 0.5 0.02" size="0.2 0.3 0.02" rgba="1 0 0 1"/>
    <geom type="box" pos="2.0 -0.4 0.03" size="0.25 0.2 0.03" quat="0.99 0 0.1 0"/>
    <geom type="box" pos="1.5 0.0 0.01" size="0.1 0.1 0.01" material="m" group="1"/>
  </worldbody>
</mujoco>
"""


def _make_joint_tree():
    """scripts/torch_port/make_joint_tree.py as a module."""
    path = ROOT / 'scripts' / 'torch_port' / 'make_joint_tree.py'
    spec = importlib.util.spec_from_file_location('make_joint_tree', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


MK = _make_joint_tree()


def _clear_caches():
    for mod in (jbuilder, pbuilder):
        mod._build_model_cached.cache_clear()
        mod._has_collidable_meshes.cache_clear()


@pytest.fixture
def assets(tmp_path, monkeypatch):
    """A robot_model directory holding the tree as go2's robot file, found
    through $GYM_QUADRUPED_ASSETS; temporary files of both packages' `build_model` under
    tmp_path."""
    pytest.importorskip('mujoco')
    root = tmp_path / 'robot_model'
    MK.write_robot_assets(root)
    monkeypatch.setenv('GYM_QUADRUPED_ASSETS', str(root))
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    _clear_caches()
    yield root
    _clear_caches()


def _same_model(got, want, where):
    for f in dataclasses.fields(Model):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape \
                and np.array_equal(a, b), f'{where}: {f.name}'
        else:
            assert a == b and type(a) is type(b), f'{where}: {f.name} {a!r} != {b!r}'


@pytest.mark.parametrize('scene', SCENES)
def test_scene_builds_as_the_reference(assets, tmp_path, scene):
    texts = {}
    for name, mod in (('port', pbuilder), ('reference', jbuilder)):
        out = tmp_path / name
        out.mkdir()
        path, limits = mod.compose_scene_xml('go2', scene, 10, out_dir=str(out))
        texts[name] = (Path(path).read_text().replace(str(out), '<out>'), limits)
        assert Path(path).parent == out
    assert texts['port'] == texts['reference']
    got, want = pbuilder.build_model('go2', scene), jbuilder.build_model('go2', scene)
    _same_model(got, want, scene)
    assert got.scene == scene and got.terrain_limits == tuple(texts['port'][1])
    assert pbuilder.build_model('go2', scene) is got     # cached, as the reference's


def test_procedural_draws_as_the_reference():
    """Other seeds and hip heights: the same documents and limits (the draw
    order is the reference's), random_pyramids' tier count taken from its
    shape-(1,) draw without NumPy's deprecation warning."""
    for scene in ('random_boxes', 'random_pyramids'):
        for seed, hip in ((0, 0.3), (7, 0.45), (123, 0.225)):
            with warnings.catch_warnings():
                warnings.simplefilter('error', DeprecationWarning)
                tree, limits = pscenes.generate_scene(scene, hip, seed)
            jtree, jlimits = jscenes.generate_scene(scene, hip, seed)
            assert limits == jlimits
            assert ET.tostring(tree.getroot()) == ET.tostring(jtree.getroot())
    with pytest.raises(ValueError, match='Invalid scene name'):
        pscenes.generate_scene('moon', 0.3)
    with pytest.raises(ValueError, match='heightfield image'):
        pscenes.generate_scene('perlin', 0.3)


def test_robot_scene_from_reference_xml(assets, tmp_path):
    (assets / 'go2' / 'scene_rough.xml').write_text(ROUGH)
    got, want = pbuilder.build_model('go2', 'rough'), jbuilder.build_model('go2', 'rough')
    _same_model(got, want, 'rough')
    assert int(((got.geom_bodyid == 0) & (got.geom_type == 6)).sum()) == 3
    assert got.terrain_limits != (10000.0, -10000.0, 10000.0, -10000.0)
    bad = tmp_path / 'scene_bad.xml'
    bad.write_text(ROUGH.replace('rgba="1 0 0 1"', 'friction="0.3 0.005 0.0001"'))
    for mod in (pscenes, jscenes):
        with pytest.raises(ValueError, match='unsupported attribute'):
            mod.make_from_reference_xml(bad)
    for mod in (pbuilder, jbuilder):
        with pytest.raises(ValueError, match='not a built-in scene'):
            mod.build_model('go2', 'no_such_scene')


def test_mesh_tail_keeps_its_hull(assets):
    robot = assets / 'go2' / 'go2.xml'
    text = robot.read_text()
    capsule = '<geom name="tail" type="capsule" fromto="0 0 0 -0.32 0 0.08" size="0.015"/>'
    assert capsule in text
    text = text.replace(capsule, '<geom name="tail" type="mesh" mesh="tail_hull"/>')
    text = text.replace('<worldbody>', f'<asset>\n    <mesh name="tail_hull" vertex="{TAIL_HULL}"/>'
                                       f'\n  </asset>\n  <worldbody>', 1)
    robot.write_text(text)
    assert pbuilder._has_collidable_meshes('go2') and jbuilder._has_collidable_meshes('go2')
    for scene in ('flat', 'random_pyramids'):
        got, want = pbuilder.build_model('go2', scene), jbuilder.build_model('go2', scene)
        _same_model(got, want, f'mesh tail on {scene}')
        assert got.mesh_vert.shape == (1, 8, 3) and got.mesh_vertnum.tolist() == [8]
        assert (got.mesh_nbr[0] >= 0).sum(1).min() >= 3     # every hull vertex has neighbours
        tail = got.geom_names.index('tail')
        assert got.geom_type[tail] == 7 and got.geom_dataid[tail] == 0


def test_fixtures_rebuild(assets):
    _same_model(MK.flat_model(), Model.load(JOINT_TREE), 'jointtree-flat.npz')
    fresh = pbuilder.build_model('go2', 'random_pyramids')
    _same_model(fresh, Model.load(JOINT_TREE_PYRAMIDS), 'jointtree-random_pyramids.npz')
    # no archive of go2/random_pyramids is compiled: load_model builds it
    assert not (pmodel.COMPILED_DIR / 'go2-random_pyramids.npz').exists()
    dm = pmodel.load_model('go2', 'random_pyramids', sim_dt=0.001, device='cpu',
                           dtype=torch.float64)
    assert dm.m.timestep == 0.001 and dm.timestep == 0.001
    _same_model(dataclasses.replace(dm.m, timestep=fresh.timestep), fresh, 'load_model')


def test_display_model(assets):
    """The display model keeps what the physics model keeps here (no mesh to
    strip) and compiles the same scene."""
    (got, limits), (want, jlimits) = (pbuilder.build_display_mj_model('go2', 'stairs'),
                                      jbuilder.build_display_mj_model('go2', 'stairs'))
    assert limits == jlimits
    for f in ('nq', 'nv', 'nbody', 'ngeom', 'nmesh'):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.geom_pos, want.geom_pos)


def test_no_assets_raises(monkeypatch, tmp_path):
    monkeypatch.setenv('GYM_QUADRUPED_ASSETS', str(tmp_path / 'none'))
    _clear_caches()
    with pytest.raises(FileNotFoundError, match='assets not found'):
        pbuilder.build_model('go2', 'random_pyramids')
    with pytest.raises(FileNotFoundError):
        pmodel.load_model('go2', 'random_pyramids', device='cpu')
    _clear_caches()


def test_import_leaves_mujoco_out():
    env = {**os.environ, 'PYTHONPATH': os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get('PYTHONPATH')] if p])}
    code = ('import sys, gym_quadruped_tpu_torch.models.builder, '
            'gym_quadruped_tpu_torch.models.scenes, gym_quadruped_tpu_torch.models.model, '
            'gym_quadruped_tpu_torch.utils.replay, gym_quadruped_tpu_torch.utils.mujoco_visual; '
            'print(sorted(m for m in sys.modules if m.split(".")[0] in ("mujoco", "jax")))')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == '[]'
