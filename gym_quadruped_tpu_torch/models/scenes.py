"""Scene synthesis (the port's copy of gym_quadruped_tpu/models/scenes.py).

Scenes are written as minimal physics MJCF documents with numpy and
ElementTree alone, then merged with a robot MJCF include by
`models.builder.compose_scene_xml`. The documents, their terrain limits and
the random draws of the procedural scenes are the JAX package's, character
for character.

Static scene geometry reproduced from the reference scene XMLs:
  * flat:     infinite plane (scene_flat.xml, utils/mujoco/assets/)
  * stairs:   plane + 50 steps, rise 0.05 / run 0.1 starting at x=1.1 (scene_stairs.xml)
  * ramp:     plane + one tilted box, pitch quat (1,0,-0.2,0) (scene_ramp.xml)
  * slippery: plane + two low-friction priority-2 boxes (scene_slippery.xml)
Procedural scenes (perlin / random_boxes / random_pyramids) reproduce
terrain.py:309-364's generators, under a locally-seeded RNG (seed=10 by default,
matching quadruped_env.py:154-156).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

STATIC_SCENES = ('flat', 'stairs', 'ramp', 'slippery')
PROCEDURAL_SCENES = ('perlin', 'random_boxes', 'random_pyramids')

# Unbounded terrain limits used for static scenes (terrain.py:322,357-359):
# (x_max, x_min, y_max, y_min)
_UNBOUNDED = (10000.0, -10000.0, 10000.0, -10000.0)


def _vec(v) -> str:
    return ' '.join(str(x) for x in v)


def _base_scene(name: str) -> tuple[ET.ElementTree, ET.Element, ET.Element]:
    root = ET.Element('mujoco', {'model': f'scene_{name}'})
    # lighting for the viewer / offscreen RGB camera (scene_flat.xml:4,31);
    # invisible to physics and to the compiled array model
    visual = ET.SubElement(root, 'visual')
    ET.SubElement(visual, 'headlight', {'diffuse': '0.4 0.4 0.4',
                                        'ambient': '0.25 0.25 0.25',
                                        'specular': '0.25 0.25 0.25'})
    asset = ET.SubElement(root, 'asset')
    ET.SubElement(asset, 'texture', {
        'name': 'groundplane', 'type': '2d', 'builtin': 'checker',
        'rgb1': '0.2 0.3 0.4', 'rgb2': '0.1 0.2 0.3',
        'width': '300', 'height': '300', 'mark': 'edge',
        'markrgb': '0.8 0.8 0.8'})
    ET.SubElement(asset, 'material', {
        'name': 'groundplane', 'texture': 'groundplane', 'texuniform': 'true',
        'texrepeat': '5 5', 'reflectance': '0.05'})
    worldbody = ET.SubElement(root, 'worldbody')
    ET.SubElement(worldbody, 'light', {'pos': '0 0 5.0', 'dir': '0 0 -1',
                                       'directional': 'true'})
    ET.SubElement(worldbody, 'geom', {'name': 'floor', 'size': '0 0 0.05',
                                      'type': 'plane',
                                      'material': 'groundplane'})
    return ET.ElementTree(root), asset, worldbody


def _add_box(worldbody: ET.Element, pos, size_full, euler=None, quat=None, **extra):
    """Add a box geom; `size_full` is the full extent (halved for MJCF), matching
    terrain.py:123-143's add_box convention."""
    attrib = {
        'type': 'box',
        'pos': _vec(pos),
        'size': _vec(0.5 * np.asarray(size_full, dtype=float)),
    }
    if quat is not None:
        attrib['quat'] = _vec(quat)
    elif euler is not None:
        attrib['quat'] = _vec(_euler_xyz_to_quat_wxyz(np.asarray(euler, dtype=float)))
    attrib.update({k: str(v) for k, v in extra.items()})
    ET.SubElement(worldbody, 'geom', attrib)


def _euler_xyz_to_quat_wxyz(e: np.ndarray) -> np.ndarray:
    half = 0.5 * e
    cr, cp, cy = np.cos(half)
    sr, sp, sy = np.sin(half)
    return np.array([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ])


def make_flat():
    tree, _, _ = _base_scene('flat')
    return tree, _UNBOUNDED


def make_stairs():
    tree, _, wb = _base_scene('stairs')
    for i in range(50):
        _add_box(wb, pos=(1.1 + 0.1 * i, 0.0, 0.025 + 0.05 * i), size_full=(0.1, 2.5, 0.05))
    return tree, _UNBOUNDED


def make_ramp():
    tree, _, wb = _base_scene('ramp')
    _add_box(wb, pos=(0.5, 0.0, 0.025), size_full=(8.1, 2.5, 0.05), quat=(1.0, 0.0, -0.20, 0.0))
    return tree, _UNBOUNDED


def make_slippery():
    tree, _, wb = _base_scene('slippery')
    _add_box(wb, pos=(18.0, 0.0, -0.19), size_full=(26.0, 1.0, 0.4),
             priority=2, friction='0.03 0.05 0.07', name='slippery_surface_1')
    _add_box(wb, pos=(2.0, 0.0, -0.19), size_full=(6.0, 1.0, 0.4),
             priority=2, friction='0.8 0.2 0.3', name='slippery_surface_2')
    return tree, _UNBOUNDED


def make_random_boxes(hip_height: float, rng: np.random.RandomState):
    """Randomized box grid; parameters follow terrain.py:333-344 via add_world_of_boxes.

    RNG draw order matches the reference exactly so seed=10 gives the same terrain.
    """
    tree, _, wb = _base_scene('random_boxes')
    init_pos = np.array([0.5, -3.0, 0.02])
    nums = (10, 10)
    separation = np.array([2 * hip_height, 2 * hip_height])
    box_size = np.array([2 * hip_height, 2 * hip_height, hip_height / 2.0])
    box_size_rand = np.array([0.5 * hip_height, 0.5 * hip_height, hip_height / 2])
    box_euler_rand = np.array([0.1, 0.1, 2 * np.pi])
    separation_rand = np.array([0.0, 1.0])

    max_abs_x = max_abs_y = 0.0
    sign_x = sign_y = 0
    local_pos = np.zeros(3)
    new_separation = separation + separation_rand * rng.uniform(-1.0, 1.0, 2)
    for _i in range(nums[0]):
        local_pos[0] += new_separation[0]
        local_pos[1] = 0.0
        for _j in range(nums[1]):
            size_xy = box_size[:2] + box_size_rand[:2] * rng.uniform(-0.2, 0.2, 2)
            size_z = box_size[2] + box_size_rand[2] * rng.uniform(-0.1, 0.15, 1)
            new_size = np.array([size_xy[0], size_xy[1], size_z[0]])
            new_euler = box_euler_rand * rng.uniform(-1.0, 1.0, 3)  # random_roll_pitch=True
            sep_x = separation[0] + separation_rand[0] * rng.uniform(0, 0.5, 1)
            sep_y = separation[1] + separation_rand[1] * rng.uniform(-0.5, 0.5, 1)
            new_separation = np.array([sep_x[0], sep_y[0]])
            local_pos[1] += new_separation[1]
            pos = local_pos + init_pos  # outer euler is zero in the reference call
            _add_box(wb, pos=pos, size_full=new_size, euler=new_euler)
            tmp_x, tmp_y = abs(local_pos[0] + init_pos[0]), abs(local_pos[1] + init_pos[1])
            if tmp_x >= max_abs_x:
                max_abs_x, sign_x = tmp_x, (1 if tmp_x > 0 else -1)
            if tmp_y >= max_abs_y:
                max_abs_y, sign_y = tmp_y, (1 if tmp_y > 0 else -1)

    max_x, max_y = max_abs_x * sign_x, max_abs_y * sign_y
    center = ((max_x + init_pos[0]) / 2, (max_y + init_pos[1]) / 2)
    if max_abs_x >= max_abs_y:
        radius = 1.2 * np.sqrt(2 * (max_x - center[0]) ** 2)
    else:
        radius = 1.2 * np.sqrt(2 * (max_y - center[1]) ** 2)
    limits = (center[0] + radius, center[0] - radius, center[1] + radius, center[1] - radius)
    return tree, limits


def make_random_pyramids(hip_height: float, rng: np.random.RandomState):
    """Pyramid of stacked boxes; parameters follow terrain.py:346-352."""
    tree, _, wb = _base_scene('random_pyramids')
    init_pos = np.array([3.0, 0.0, 0.02])
    width = length = 10 * hip_height
    max_height = 5 * hip_height
    stair_nums = rng.uniform(2, 8, 1)
    yaw = 0.0

    local_pos = np.array([0.0, 0.0, -0.05])
    height_rand = rng.uniform(0.08, max_height, 1)
    stride_rand = rng.uniform(0.5, 1.0, 1)
    max_abs_x = max_abs_y = 0.0
    center = (init_pos[0], init_pos[1])
    # the draw is a shape-(1,) array: take its element (int() of the array
    # itself is deprecated in NumPy >= 1.25); the count and the draws after
    # it are the same
    for i in range(int(stair_nums[0])):
        local_pos[2] += height_rand[0]
        x, y = local_pos[0], local_pos[1]  # yaw = 0
        new_width = width - stride_rand[0] * i
        new_length = length - stride_rand[0] * i
        if new_width < 0.3 or new_length < 0.3:
            break
        _add_box(wb, pos=(x + init_pos[0], y + init_pos[1], local_pos[2]),
                 size_full=(new_width, new_length, height_rand[0]), euler=(0.0, 0.0, yaw))
        if i == 0:
            max_abs_x = abs(x + init_pos[0] + new_width / 2.0)
            max_abs_y = abs(y + init_pos[1] + new_length / 2.0)
            center = (x + init_pos[0], y + init_pos[1])

    if max_abs_x >= max_abs_y:
        radius = 1.5 * np.sqrt(2 * (max_abs_x - center[0]) ** 2)
    else:
        radius = 1.5 * np.sqrt(2 * (max_abs_y - center[1]) ** 2)
    limits = (center[0] + radius, center[0] - radius, center[1] + radius, center[1] - radius)
    return tree, limits


def make_perlin(hip_height: float, hfield_png_path: str):
    """Perlin heightfield scene; parameters follow terrain.py:354-364 & add_perlin_heightfield.

    The heightfield image itself is generated by the caller and saved to
    `hfield_png_path` before calling this; `models.builder` declares a size-only
    heightfield instead and writes `terrain.perlin`'s data after compiling.
    """
    tree, asset, wb = _base_scene('perlin')
    size = (hip_height * 100, hip_height * 100)
    max_height = 2 * hip_height
    min_height = 0.005
    ET.SubElement(asset, 'hfield', {
        'name': 'perlin_hfield',
        'size': _vec([size[0] / 2.0, size[1] / 2.0, max_height, min_height]),
        'file': str(hfield_png_path),
    })
    ET.SubElement(wb, 'geom', {
        'type': 'hfield', 'hfield': 'perlin_hfield',
        'pos': '0 0 0', 'quat': '1 0 0 0',
    })
    center = (0.0, 0.0)
    radius = 0.8 * np.sqrt((size[0] / 2.0) ** 2)
    limits = (center[0] + radius, center[0] - radius, center[1] + radius, center[1] - radius)
    return tree, limits


def make_from_reference_xml(xml_path):
    """Import a shipped per-robot scene XML.

    The reference ships extra scenes under robot_model/<robot>/scene_*.xml
    (aliengo scene_rough/scene_stairs, mini_cheetah scene_slope/
    scene_suspend_stairs, hyqreal1 scene_rough) that its own `scene=` arg
    cannot reach (quadruped_env.py:153 only resolves robot_model/
    scene_<name>.xml). Here they are reachable: the box geoms are imported
    verbatim into the physics-only base scene (the robot <include> and
    visual assets are re-synthesized as for every other scene).

    Terrain limits follow the random-boxes convention: the 0.8-shrunk
    bounding box of the imported geoms; scenes with no extra geoms (slope /
    suspend_stairs ship only a floor plane) get the static-scene unbounded
    limits.
    """
    import pathlib

    src = ET.parse(str(xml_path))
    name = pathlib.Path(xml_path).stem.replace('scene_', '')
    tree, asset, wb = _base_scene(name)
    xs, ys = [], []
    # only these geom attributes are carried over; anything else that can
    # change geometry or contact behavior must fail loudly rather than be
    # silently dropped (a scene using euler/friction/... would import with
    # wrong physics)
    copied = ('type', 'pos', 'size', 'quat')
    ignorable = ('name', 'rgba', 'material', 'group', 'class')  # visual only
    # NOTE contype/conaffinity are deliberately NOT ignorable: they change
    # contact filtering and must be handled explicitly if a scene uses them
    for geom in src.getroot().find('worldbody').findall('geom'):
        if geom.get('type', 'sphere') == 'plane':
            continue  # base scene provides the floor
        unknown = [k for k in geom.keys() if k not in copied + ignorable]
        if unknown:
            raise ValueError(
                f'{xml_path}: geom carries unsupported attribute(s) '
                f'{unknown}; extend make_from_reference_xml before importing '
                'this scene (silently dropping them would corrupt physics)')
        attrs = {k: geom.get(k) for k in copied if geom.get(k) is not None}
        ET.SubElement(wb, 'geom', attrs)
        if 'pos' in attrs:
            px, py, _ = (float(v) for v in attrs['pos'].split())
            xs.append(px)
            ys.append(py)
    if not xs:
        return tree, _UNBOUNDED
    x_lo, x_hi = min(xs), max(xs)
    y_lo, y_hi = min(ys), max(ys)
    cx, cy = 0.5 * (x_lo + x_hi), 0.5 * (y_lo + y_hi)
    rx, ry = 0.8 * 0.5 * (x_hi - x_lo), 0.8 * 0.5 * (y_hi - y_lo)
    return tree, (cx + rx, cx - rx, cy + ry, cy - ry)


def generate_scene(scene: str, hip_height: float, seed: int = 10,
                   hfield_png_path: str | None = None):
    """Dispatch equivalent to terrain.py:309-364's generate_terrain.

    Returns (ElementTree, terrain_limits=(x_max, x_min, y_max, y_min)).
    """
    rng = np.random.RandomState(seed)
    if scene == 'flat':
        return make_flat()
    if scene == 'stairs':
        return make_stairs()
    if scene == 'ramp':
        return make_ramp()
    if scene == 'slippery':
        return make_slippery()
    if scene == 'random_boxes':
        return make_random_boxes(hip_height, rng)
    if scene == 'random_pyramids':
        return make_random_pyramids(hip_height, rng)
    if scene == 'perlin':
        if hfield_png_path is None:
            raise ValueError('perlin scene requires a generated heightfield image path')
        return make_perlin(hip_height, hfield_png_path)
    raise ValueError(
        f'Invalid scene name: {scene}, available: '
        f'{STATIC_SCENES + PROCEDURAL_SCENES}'
    )
