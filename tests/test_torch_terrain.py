"""The port's Perlin terrain (gym_quadruped_tpu_torch/terrain/perlin.py)
against the JAX package's, bit for bit: the noise itself, the 128 x 128
uint8 image of the perlin scenes (the committed golden fixture), and the
normalised heightfield every compiled `*-perlin.npz` carries (stored as
float32)."""

import pathlib

import numpy as np
import pytest

from gym_quadruped_tpu.terrain import perlin as jperlin
from gym_quadruped_tpu_torch.terrain import perlin

GOLDEN = pathlib.Path(__file__).parent / 'fixtures' / 'perlin_golden_128.npy'
COMPILED = pathlib.Path(__file__).parents[1] / 'gym_quadruped_tpu' / 'models' / 'compiled'
ROBOTS = ['go2', 'spot', 'aliengo', 'b2', 'hyqreal2']


def test_noise_matches_reference():
    rng = np.random.default_rng(7)
    x, y = rng.uniform(-40, 300, 4096), rng.uniform(-40, 300, 4096)
    np.testing.assert_array_equal(perlin.noise2(x, y), jperlin.noise2(x, y))
    for octaves in (1, 3, 5):
        got = perlin.pnoise2(x, y, octaves=octaves, persistence=0.5, lacunarity=4.0)
        ref = jperlin.pnoise2(x, y, octaves=octaves, persistence=0.5, lacunarity=4.0)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        perlin.pnoise2(x, y, octaves=0)


def test_image_matches_golden_fixture():
    golden = np.load(GOLDEN)
    img = perlin.perlin_image()
    assert img.dtype == golden.dtype == np.uint8
    np.testing.assert_array_equal(img, golden)


def test_reference_hfield_matches_reference_and_golden():
    h = perlin.reference_perlin_hfield()
    np.testing.assert_array_equal(h, jperlin.reference_perlin_hfield())
    g = np.load(GOLDEN).astype(np.float64)
    np.testing.assert_array_equal(h, (g - g.min()) / (g.max() - g.min()))


@pytest.mark.parametrize('robot', ROBOTS)
def test_reference_hfield_matches_compiled_scene(robot):
    with np.load(COMPILED / f'{robot}-perlin.npz') as z:
        data = z['hfield_data']
    assert data.dtype == np.float32 and data.shape == (128, 128)
    np.testing.assert_array_equal(perlin.reference_perlin_hfield().astype(np.float32), data)
