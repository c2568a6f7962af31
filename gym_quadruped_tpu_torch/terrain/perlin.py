"""Classic Perlin-noise heightfields, vectorised numpy, at model-build time.

Counterpart of gym_quadruped_tpu/terrain/perlin.py. It transcribes the C
`noise2` of the `noise` package (caseman/noise, `_perlin.c`), whose dialect
of classic Perlin noise differs from Ken Perlin's 2002 code in two ways that
change every height:

  * the lattice hash is ``PERM[PERM[i & 255] + (j & 255)]``, and its result
    picks the gradient directly;
  * the gradient is row ``hash & 15`` of a 16-row table (the 12 cube edges
    and 4 repeated rows), not ``hash % 12``;

and all arithmetic is float32 (C ``float``), the octave loop of `pnoise2`
included. `perlin_image` is the uint8 image the perlin scenes are generated
from (x/smooth, y/smooth, 5 octaves, persistence 0.5, lacunarity 4, the
value truncated by ``int((n + 1) / 2 * 255)``); `perlin_hfield` applies the
min-max normalisation of MuJoCo's PNG heightfield loader to it. The step
only samples the heightfield (physics/collision.py), so this module stays
host code.
"""

from __future__ import annotations

import numpy as np

# Ken Perlin's permutation table ("Improved Noise", 2002), as the `noise`
# package ships it, doubled so that PERM[PERM[i] + j] needs no wrap.
_PERM = np.array([
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
    74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
    60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
    65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
    200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64,
    52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212,
    207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213,
    119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104,
    218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241,
    81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157,
    184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93,
    222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180,
], dtype=np.int64)
_PERM = np.concatenate([_PERM, _PERM])

# GRAD3 of `_perlin.c`: the 12 cube-edge vectors and 4 repeats, indexed by
# `hash & 15`; 2D noise reads the first two components.
_GRAD3 = np.array([
    [1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
    [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
    [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
    [1, 0, -1], [-1, 0, -1], [0, -1, 1], [0, 1, 1],
], dtype=np.float32)

_F32 = np.float32


def _fade(t):
    return t * t * t * (t * (t * _F32(6.0) - _F32(15.0)) + _F32(10.0))


def _grad2(h, x, y):
    g = _GRAD3[h & 15]
    return g[..., 0] * x + g[..., 1] * y


def noise2(x, y, repeatx: float = 1024.0, repeaty: float = 1024.0,
           base: int = 0) -> np.ndarray:
    """Single-octave 2D Perlin noise of `_perlin.c`'s `noise2`, in float32."""
    x = np.asarray(x, _F32)
    y = np.asarray(y, _F32)
    rx, ry = _F32(repeatx), _F32(repeaty)
    i = np.floor(np.fmod(x, rx)).astype(np.int64)
    j = np.floor(np.fmod(y, ry)).astype(np.int64)
    ii = np.fmod((i + 1).astype(_F32), rx).astype(np.int64)
    jj = np.fmod((j + 1).astype(_F32), ry).astype(np.int64)
    i = (i & 255) + base
    j = (j & 255) + base
    ii = (ii & 255) + base
    jj = (jj & 255) + base

    fx = x - np.floor(x)
    fy = y - np.floor(y)
    u = _fade(fx)
    v = _fade(fy)

    A = _PERM[i]
    B = _PERM[ii]
    one = _F32(1.0)
    n00 = _grad2(_PERM[A + j], fx, fy)
    n10 = _grad2(_PERM[B + j], fx - one, fy)
    n01 = _grad2(_PERM[A + jj], fx, fy - one)
    n11 = _grad2(_PERM[B + jj], fx - one, fy - one)
    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    return nx0 + v * (nx1 - nx0)


def pnoise2(x, y, octaves: int = 1, persistence: float = 0.5, lacunarity: float = 2.0,
            repeatx: float = 1024.0, repeaty: float = 1024.0, base: int = 0) -> np.ndarray:
    """Fractal Perlin noise of the `noise` package's `pnoise2`: a float32
    octave loop, each octave's repeat scaled by its frequency."""
    x = np.asarray(x, _F32)
    y = np.asarray(y, _F32)
    if octaves == 1:
        return noise2(x, y, repeatx, repeaty, base)
    if octaves < 1:
        raise ValueError('octaves must be >= 1')
    freq, amp, max_amp = _F32(1.0), _F32(1.0), _F32(0.0)
    total = np.zeros(np.broadcast(x, y).shape, _F32)
    pers, lac = _F32(persistence), _F32(lacunarity)
    for _ in range(octaves):
        total = total + noise2(x * freq, y * freq, repeatx * freq, repeaty * freq, base) * amp
        max_amp = max_amp + amp
        freq = freq * lac
        amp = amp * pers
    return total / max_amp


def perlin_image(nrow: int = 128, ncol: int = 128, smooth: float = 50.0, octaves: int = 5,
                 persistence: float = 0.5, lacunarity: float = 4.0) -> np.ndarray:
    """(nrow, ncol) uint8 image: per pixel `pnoise2(x / smooth, y / smooth)`
    mapped to [0, 255] and truncated, as the C `int()` of the float value."""
    ys, xs = np.meshgrid(np.arange(nrow), np.arange(ncol), indexing='ij')
    n = pnoise2((xs / smooth).astype(np.float64), (ys / smooth).astype(np.float64),
                octaves=octaves, persistence=persistence, lacunarity=lacunarity)
    return np.trunc((n.astype(np.float64) + 1.0) / 2.0 * 255.0).astype(np.uint8)


def perlin_hfield(nrow: int = 128, ncol: int = 128, smooth: float = 50.0, octaves: int = 5,
                  persistence: float = 0.5, lacunarity: float = 4.0) -> np.ndarray:
    """(nrow, ncol) float64 heightfield in [0, 1]: `perlin_image` min-max
    normalised, as MuJoCo loads a PNG heightfield."""
    img = perlin_image(nrow, ncol, smooth, octaves, persistence, lacunarity).astype(np.float64)
    lo, hi = img.min(), img.max()
    return (img - lo) / max(hi - lo, 1e-12)


def reference_perlin_hfield() -> np.ndarray:
    """The heightfield of the perlin scenes: 128 x 128, smooth 50, 5 octaves,
    persistence 0.5, lacunarity 4."""
    return perlin_hfield(128, 128, smooth=50.0, octaves=5, persistence=0.5, lacunarity=4.0)
