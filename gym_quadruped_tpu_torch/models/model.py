"""Frozen physics model and its device tensors.

`Model` is a copy of the JAX package's static model bundle
(gym_quadruped_tpu/models/model.py): numpy arrays named after mjModel's fields,
read from the same compiled `.npz` archives. The physics reads its float
arrays as tensors of one device and dtype from a `DeviceModel`, which also
carries the numpy `Model` for the static structure (tree topology, joint
types, pair lists) that the Python loops unroll over.
"""

from __future__ import annotations

import dataclasses
import io
import json
from pathlib import Path

import numpy as np
import torch

# mjtJoint
FREE, BALL, SLIDE, HINGE = 0, 1, 2, 3
# mjtGeom (subset)
GEOM_PLANE, GEOM_HFIELD, GEOM_SPHERE, GEOM_CAPSULE, GEOM_ELLIPSOID, GEOM_CYLINDER, GEOM_BOX, GEOM_MESH = (
    0, 1, 2, 3, 4, 5, 6, 7)
# mjtCone
CONE_PYRAMIDAL, CONE_ELLIPTIC = 0, 1

# The compiled archives ship inside the JAX package; they are data files, read
# by path, so the port needs nothing else from that package.
COMPILED_DIR = Path(__file__).resolve().parents[2] / 'gym_quadruped_tpu' / 'models' / 'compiled'
# A test model of the port's own: every joint type on one tree, under go2's
# names, on a floor and on the random_pyramids scene at seed 10
# (scripts/torch_port/make_joint_tree.py writes both).
JOINT_TREE = Path(__file__).resolve().parent / 'fixtures' / 'jointtree-flat.npz'
JOINT_TREE_PYRAMIDS = JOINT_TREE.with_name('jointtree-random_pyramids.npz')

_TUPLE_FIELDS = ('terrain_limits', 'body_names', 'jnt_names', 'geom_names',
                 'site_names', 'cam_names')


# eq=False: a Model hashes by identity, so the static tables derived from it
# (contact and constraint layouts) can be cached per model.
@dataclasses.dataclass(frozen=True, eq=False)
class Model:
    """Static model arrays (numpy), field for field as in the JAX package."""

    # --- metadata -------------------------------------------------------------
    robot: str
    scene: str
    hip_height: float
    terrain_limits: tuple  # (x_max, x_min, y_max, y_min)

    # --- sizes ----------------------------------------------------------------
    nq: int
    nv: int
    nu: int
    nbody: int
    njnt: int
    ngeom: int
    nsite: int

    # --- options --------------------------------------------------------------
    timestep: float
    gravity: np.ndarray          # (3,)
    cone: int                    # 0 pyramidal, 1 elliptic
    impratio: float

    # --- bodies ---------------------------------------------------------------
    body_parentid: np.ndarray    # (nbody,) int
    body_jntadr: np.ndarray      # (nbody,) int
    body_jntnum: np.ndarray      # (nbody,) int
    body_dofadr: np.ndarray      # (nbody,) int
    body_dofnum: np.ndarray      # (nbody,) int
    body_geomadr: np.ndarray     # (nbody,) int
    body_geomnum: np.ndarray     # (nbody,) int
    body_pos: np.ndarray         # (nbody, 3)
    body_quat: np.ndarray        # (nbody, 4)
    body_ipos: np.ndarray        # (nbody, 3)
    body_iquat: np.ndarray       # (nbody, 4)
    body_mass: np.ndarray        # (nbody,)
    body_inertia: np.ndarray     # (nbody, 3)
    body_invweight0: np.ndarray  # (nbody, 2)

    # --- joints ---------------------------------------------------------------
    jnt_type: np.ndarray         # (njnt,) int
    jnt_qposadr: np.ndarray      # (njnt,) int
    jnt_dofadr: np.ndarray       # (njnt,) int
    jnt_bodyid: np.ndarray       # (njnt,) int
    jnt_limited: np.ndarray      # (njnt,) bool
    jnt_pos: np.ndarray          # (njnt, 3)
    jnt_axis: np.ndarray         # (njnt, 3)
    jnt_range: np.ndarray        # (njnt, 2)
    jnt_stiffness: np.ndarray    # (njnt,)
    jnt_solref: np.ndarray       # (njnt, 2)
    jnt_solimp: np.ndarray       # (njnt, 5)
    jnt_margin: np.ndarray       # (njnt,)

    # --- dofs -----------------------------------------------------------------
    dof_bodyid: np.ndarray       # (nv,) int
    dof_jntid: np.ndarray        # (nv,) int
    dof_parentid: np.ndarray     # (nv,) int (-1 root)
    dof_armature: np.ndarray     # (nv,)
    dof_damping: np.ndarray      # (nv,)
    dof_frictionloss: np.ndarray # (nv,)
    dof_invweight0: np.ndarray   # (nv,)
    dof_solref: np.ndarray       # (nv, 2)
    dof_solimp: np.ndarray       # (nv, 5)

    # --- geoms ------------------------------------------------------------------
    geom_type: np.ndarray        # (ngeom,) int
    geom_bodyid: np.ndarray      # (ngeom,) int
    geom_contype: np.ndarray     # (ngeom,) int
    geom_conaffinity: np.ndarray # (ngeom,) int
    geom_condim: np.ndarray      # (ngeom,) int
    geom_priority: np.ndarray    # (ngeom,) int
    geom_pos: np.ndarray         # (ngeom, 3)
    geom_quat: np.ndarray        # (ngeom, 4)
    geom_size: np.ndarray        # (ngeom, 3)
    geom_friction: np.ndarray    # (ngeom, 3)
    geom_solmix: np.ndarray      # (ngeom,)
    geom_solref: np.ndarray      # (ngeom, 2)
    geom_solimp: np.ndarray      # (ngeom, 5)
    geom_margin: np.ndarray      # (ngeom,)
    geom_gap: np.ndarray         # (ngeom,)

    # --- sites ------------------------------------------------------------------
    site_bodyid: np.ndarray      # (nsite,) int
    site_pos: np.ndarray         # (nsite, 3)
    site_quat: np.ndarray        # (nsite, 4)

    # --- cameras ------------------------------------------------------------------
    cam_bodyid: np.ndarray       # (ncam,) int
    cam_pos: np.ndarray          # (ncam, 3)
    cam_quat: np.ndarray         # (ncam, 4)
    cam_fovy: np.ndarray         # (ncam,)

    # --- actuators ----------------------------------------------------------------
    actuator_trnid: np.ndarray      # (nu,) joint id
    actuator_gear: np.ndarray       # (nu,) gear[0]
    actuator_ctrlrange: np.ndarray  # (nu, 2)
    actuator_ctrllimited: np.ndarray  # (nu,) bool
    actuator_forcerange: np.ndarray   # (nu, 2)
    actuator_forcelimited: np.ndarray  # (nu,) bool

    # --- reference pose / keyframes -------------------------------------------
    qpos0: np.ndarray            # (nq,)
    qpos_spring: np.ndarray      # (nq,)
    key_qpos: np.ndarray         # (nkey, nq)
    key_qvel: np.ndarray         # (nkey, nv)
    key_ctrl: np.ndarray         # (nkey, nu)

    # --- heightfield (optional; zero-size when absent) --------------------------
    hfield_size: np.ndarray      # (4,) x_half, y_half, z_top, z_bottom
    hfield_nrow: int
    hfield_ncol: int
    hfield_data: np.ndarray      # (nrow, ncol) in [0, 1]

    # --- name tables (static metadata) ------------------------------------------
    body_names: tuple
    jnt_names: tuple
    geom_names: tuple
    site_names: tuple
    cam_names: tuple

    # --- quadruped conveniences (FL, FR, RL, RR order) ---------------------------
    feet_geom_id: np.ndarray     # (4,) int
    feet_body_id: np.ndarray     # (4,) int
    legs_qpos_idx: np.ndarray    # (4, 3) int
    legs_qvel_idx: np.ndarray    # (4, 3) int
    legs_tau_idx: np.ndarray     # (4, 3) int
    hip_body_id: np.ndarray      # (4,) int
    imu_site_id: int             # -1 when absent

    # --- precomputed collision candidate pairs (world geom, robot geom) ----------
    contact_pairs: np.ndarray    # (npair, 2) int

    # --- convex hulls of collidable mesh geoms (optional; zero-size when absent) -
    geom_dataid: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))   # (ngeom,) -1 if not mesh
    geom_rbound: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))             # (ngeom,)
    mesh_vert: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0, 3)))     # (nmesh, Vmax, 3)
    mesh_vertnum: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))   # (nmesh,)
    mesh_nbr: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0, 0), np.int32))  # (nmesh, Vmax, D)

    def name2id(self, kind: str, name: str) -> int:
        """The index of the body, joint, geom, site or camera `name`."""
        table = {'body': self.body_names, 'joint': self.jnt_names, 'geom': self.geom_names,
                 'site': self.site_names, 'camera': self.cam_names}[kind]
        return table.index(name)

    @property
    def base_body_id(self) -> int:
        """The floating-base body (child of world holding the free joint)."""
        return int(self.jnt_bodyid[np.where(self.jnt_type == FREE)[0][0]])

    def save(self, path: str | Path):
        """Write the archive in the JAX package's format (`Model.save` there):
        every array field as an array, the other fields as JSON under
        `__meta__`. `load` reads it back, and so does the JAX package."""
        arrays, meta = {}, {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            (arrays if isinstance(v, np.ndarray) else meta)[f.name] = v
        buf = io.BytesIO()
        np.savez_compressed(buf, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
                            **arrays)
        Path(path).write_bytes(buf.getvalue())

    @classmethod
    def load(cls, path: str | Path) -> 'Model':
        with np.load(Path(path), allow_pickle=False) as z:
            meta = json.loads(bytes(z['__meta__'].tobytes()).decode())
            kwargs = dict(meta)
            for f in dataclasses.fields(cls):
                if f.name in z.files and f.name != '__meta__':
                    kwargs[f.name] = z[f.name]
        return from_arrays(kwargs)


def from_arrays(fields: dict) -> Model:
    """Build a Model from a dict of its fields (numpy arrays and scalars).

    This is how a model carries across from the JAX package: the fields of its
    `Model`, as numpy, give a port model that computes the same thing."""
    kwargs = {f.name: fields[f.name] for f in dataclasses.fields(Model)
              if f.name in fields}
    for k in _TUPLE_FIELDS:
        kwargs[k] = tuple(kwargs[k])
    for k, v in kwargs.items():
        if isinstance(v, np.ndarray):
            kwargs[k] = np.array(v)  # own copy: the model is frozen
    return Model(**kwargs)


class DeviceModel:
    """A Model's float arrays as tensors of one device and dtype.

    Every float array field of `m` is an attribute of the same name holding
    that tensor; integer and boolean tables stay numpy on `m`, where the
    physics unrolls over them. Hashes by identity, so each physics module can
    cache the device tables it derives from one model."""

    def __init__(self, m: Model, device, dtype: torch.dtype):
        self.m = m
        self.device = torch.device(device)
        self.dtype = dtype
        self.timestep = float(m.timestep)
        self._consts = {}
        for f in dataclasses.fields(m):
            v = getattr(m, f.name)
            if isinstance(v, np.ndarray) and v.dtype.kind == 'f':
                setattr(self, f.name, torch.as_tensor(v, dtype=dtype, device=self.device))

    def const(self, key, make) -> torch.Tensor:
        """A tensor derived from the static model, built by `make()` (numpy)
        on first use and kept: the step then copies nothing from the host.
        Float arrays take the model's dtype; integer and bool arrays keep
        int64 and bool."""
        t = self._consts.get(key)
        if t is None:
            a = np.asarray(make())
            dtype = self.dtype if a.dtype.kind == 'f' else (
                torch.bool if a.dtype.kind == 'b' else torch.int64)
            t = torch.as_tensor(a, device=self.device).to(dtype)
            self._consts[key] = t
        return t

    def __repr__(self):
        return (f'DeviceModel({self.m.robot}/{self.m.scene}, device={self.device}, '
                f'dtype={self.dtype})')


def to_device(m: Model, device='cuda', dtype: torch.dtype = torch.float32) -> DeviceModel:
    """The tensors the physics reads, on `device` in `dtype`."""
    return DeviceModel(m, device, dtype)


def load_model(robot: str, scene: str = 'flat', sim_dt: float = 0.002,
               device='cuda', dtype: torch.dtype = torch.float32) -> DeviceModel:
    """The model of `robot` on `scene` on `device`: its compiled archive
    where there is one, else compiled from the robot's MJCF by
    `models.builder.build_model` (which needs `mujoco` and the MJCF assets,
    and raises FileNotFoundError where there are none)."""
    path = COMPILED_DIR / f'{robot}-{scene}.npz'
    if path.exists():
        m = Model.load(path)
        if m.timestep != sim_dt:
            m = dataclasses.replace(m, timestep=sim_dt)
    else:
        from gym_quadruped_tpu_torch.models import builder

        m = builder.build_model(robot, scene, sim_dt)
    return to_device(m, device, dtype)
