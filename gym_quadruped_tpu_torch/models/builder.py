"""MJCF model compiler: a robot MJCF and a synthesized scene to a frozen `Model`.

The port's counterpart of gym_quadruped_tpu/models/builder.py. MuJoCo's CPU
bindings serve here only as an MJCF compiler, at build time on the host:
`build_model` composes the scene document (`models.scenes`) with the robot
MJCF (`models.robots.find_assets_dir`), compiles it, and copies every field
the physics reads into a `Model`, which `Model.save` writes as an archive and
`models.model.to_device` puts on the card. `mujoco` is imported inside the
functions that use it: a GPU host without it runs the step, which needs none.

    m = build_model('go2', 'random_pyramids')        # $GYM_QUADRUPED_ASSETS/go2/go2.xml
    m.save('go2-random_pyramids.npz')
"""

from __future__ import annotations

import functools
import tempfile
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from gym_quadruped_tpu_torch.models import scenes as _scenes
from gym_quadruped_tpu_torch.models.model import GEOM_MESH, HINGE, Model
from gym_quadruped_tpu_torch.models.robots import LEG_ORDER, find_assets_dir, get_robot_config


def _patch_robot_xml(robot_xml: Path, out_dir: Path) -> Path:
    """Write a physics-equivalent copy of the robot MJCF with its mesh geoms,
    mesh assets and missing textures taken out, and return its path.

    Every shipped robot declares explicit <inertial> blocks, so its mesh
    geoms carry no mass: where none of them collides, they are visual only.
    Robots that collide through meshes (hyqreal1, mini_cheetah) are never
    stripped (`build_mj_model`'s auto mode). Stripping also sidesteps mesh
    files missing from a checkout and makes the compile ~100x faster (no
    convex hulls)."""
    tree = ET.parse(robot_xml)
    root = tree.getroot()

    for parent in root.iter():
        for geom in list(parent.findall('geom')):
            if geom.get('mesh') is not None or geom.get('type') == 'mesh':
                parent.remove(geom)
    asset = root.find('asset')
    if asset is not None:
        for mesh in list(asset.findall('mesh')):
            asset.remove(mesh)
        for tex in list(asset.findall('texture')):
            f = tex.get('file')
            if f and not (robot_xml.parent / f).exists():
                asset.remove(tex)

    out_path = out_dir / robot_xml.name
    tree.write(out_path)
    return out_path


def compose_scene_xml(robot: str, scene: str = 'flat', seed: int = 10,
                      out_dir: str | None = None,
                      strip_meshes: bool = True) -> tuple[str, tuple]:
    """Write the merged scene and robot MJCF into `out_dir` (a new temporary
    directory when None, which the caller owns) and return (its path,
    terrain_limits).

    The scene document (`models.scenes`; perlin's heightfield declared by
    size, its data written after the compile; or a per-robot
    `scene_<name>.xml` beside the robot's MJCF) gets an <include> of the
    robot MJCF as its first child. strip_meshes=False includes the robot's
    own file (display models, and the physics models of mesh-colliding
    robots, `build_mj_model`)."""
    cfg = get_robot_config(robot)
    assets = find_assets_dir()
    if assets is None:
        raise FileNotFoundError(
            'Robot MJCF assets not found. Set $GYM_QUADRUPED_ASSETS or install '
            'gym-quadruped; alternatively use a compiled model archive via load_model().')
    robot_xml = (assets / cfg.mjcf_filename).resolve()
    if not robot_xml.exists():
        raise FileNotFoundError(f'Robot model file not found: {robot_xml}')

    if scene == 'perlin':
        tree, limits = _scenes.generate_scene('flat', cfg.hip_height, seed)
        tree, limits = _attach_hfield_asset(tree, cfg.hip_height)
    elif scene not in _scenes.STATIC_SCENES + _scenes.PROCEDURAL_SCENES:
        # per-robot extra scenes shipped as robot_model/<robot>/scene_*.xml
        # (aliengo rough/stairs, mini_cheetah slope/suspend_stairs, hyqreal1
        # rough), reachable by name
        robot_scene = robot_xml.parent / f'scene_{scene}.xml'
        if not robot_scene.exists():
            raise ValueError(
                f'Invalid scene {scene!r} for {robot}: not a built-in scene '
                f'({_scenes.STATIC_SCENES + _scenes.PROCEDURAL_SCENES}) and '
                f'{robot_scene} does not exist')
        tree, limits = _scenes.make_from_reference_xml(robot_scene)
    else:
        tree, limits = _scenes.generate_scene(scene, cfg.hip_height, seed)

    out_dir = Path(out_dir or tempfile.mkdtemp(prefix='gqtpu_scene_'))
    # the display model includes the robot's own MJCF by its absolute path,
    # so that its meshdir resolves
    include_xml = _patch_robot_xml(robot_xml, out_dir) if strip_meshes else robot_xml

    root = tree.getroot()
    include = ET.Element('include')
    include.attrib['file'] = str(include_xml)
    root.insert(0, include)

    out_path = out_dir / f'{cfg.name}-{scene}.xml'
    tree.write(out_path)
    return str(out_path), limits


def _attach_hfield_asset(tree, hip_height: float, nrow: int = 128, ncol: int = 128):
    """Declare the perlin scene's heightfield by size alone (its data is
    written after the compile) and put it in the world, centred."""
    root = tree.getroot()
    asset = root.find('asset')
    size = (hip_height * 100, hip_height * 100)
    max_height, min_height = 2 * hip_height, 0.005
    ET.SubElement(asset, 'hfield', {
        'name': 'perlin_hfield', 'nrow': str(nrow), 'ncol': str(ncol),
        'size': f'{size[0] / 2.0} {size[1] / 2.0} {max_height} {min_height}',
    })
    wb = root.find('worldbody')
    ET.SubElement(wb, 'geom', {'type': 'hfield', 'hfield': 'perlin_hfield',
                               'pos': '0 0 0', 'quat': '1 0 0 0'})
    radius = 0.8 * (size[0] / 2.0)
    limits = (radius, -radius, radius, -radius)
    return tree, limits


def _compile(robot: str, scene: str, seed: int, strip_meshes: bool):
    """(mjModel, terrain_limits) of the composed scene, compiled in a
    temporary directory that is gone when this returns."""
    import mujoco

    with tempfile.TemporaryDirectory(prefix='gqtpu_scene_') as out_dir:
        xml_path, limits = compose_scene_xml(robot, scene, seed, out_dir,
                                             strip_meshes=strip_meshes)
        return mujoco.MjModel.from_xml_path(xml_path), limits


@functools.lru_cache(maxsize=16)
def _has_collidable_meshes(robot: str) -> bool:
    """True when the robot's full model (meshes kept) compiles and has a
    collidable mesh geom: hyqreal1 (9 of 13 collidable geoms) and
    mini_cheetah (11 of 15) collide mostly through meshes, and their physics
    models keep them. Robots whose collidable geoms are all primitives, or
    whose mesh files are incomplete, take the stripped build. Raises
    FileNotFoundError where there are no assets."""
    try:
        m, _ = _compile(robot, 'flat', 10, strip_meshes=False)
    except ValueError:   # MuJoCo's compile error: a missing mesh file
        return False
    return any(
        int(m.geom_type[g]) == GEOM_MESH
        and (m.geom_contype[g] or m.geom_conaffinity[g])
        for g in range(m.ngeom))


def build_mj_model(robot: str, scene: str = 'flat', sim_dt: float = 0.002,
                   seed: int = 10, hfield: np.ndarray | None = None,
                   strip_meshes: bool | None = None):
    """Compile with MuJoCo and apply the post-compile settings: the robot's
    joint-space zero pose (`RobotConfig.qpos0_js`), the timestep, the perlin
    heightfield's data (`terrain.perlin.reference_perlin_hfield` unless
    `hfield` is given). Returns (mjModel, terrain_limits).
    strip_meshes=None keeps the meshes of robots that collide through them
    (`_has_collidable_meshes`) and strips them otherwise."""
    if strip_meshes is None:
        strip_meshes = not _has_collidable_meshes(robot)
    cfg = get_robot_config(robot)
    m, limits = _compile(robot, scene, seed, strip_meshes)
    if cfg.qpos0_js is not None:
        m.qpos0[7:] = np.array(cfg.qpos0_js)
    m.opt.timestep = sim_dt
    if scene == 'perlin':
        if hfield is None:
            from gym_quadruped_tpu_torch.terrain.perlin import reference_perlin_hfield
            hfield = reference_perlin_hfield()
        m.hfield_data[:] = hfield.ravel()
    return m, limits


@functools.lru_cache(maxsize=32)
def _build_model_cached(robot: str, scene: str, sim_dt: float, seed: int) -> Model:
    m, limits = build_mj_model(robot, scene, sim_dt, seed, None)
    return extract_model(m, robot, scene, limits)


def build_model(robot: str, scene: str = 'flat', sim_dt: float = 0.002,
                seed: int = 10, hfield: np.ndarray | None = None) -> Model:
    """Compile robot and scene into a frozen Model (cached, since a Model is
    immutable, unless `hfield` is given)."""
    if hfield is not None:
        m, limits = build_mj_model(robot, scene, sim_dt, seed, hfield)
        return extract_model(m, robot, scene, limits)
    return _build_model_cached(robot, scene, sim_dt, seed)


def build_display_mj_model(robot: str, scene: str = 'flat',
                           sim_dt: float = 0.002, seed: int = 10):
    """The mjModel with the robot's meshes kept, for host-side rendering
    (`utils.replay`); the stripped physics model where mesh files are
    missing (collision primitives are drawn then)."""
    try:
        return build_mj_model(robot, scene, sim_dt, seed, strip_meshes=False)
    except ValueError:   # MuJoCo's compile error: a missing mesh file
        return build_mj_model(robot, scene, sim_dt, seed)


def _reachable_pairs(m, candidates, n_samples: int = 4000,
                     safety: float = 0.05, seed: int = 0):
    """Self-collision pairs whose bounding spheres can come within `safety`
    over sampled joint configurations (build-time static broadphase).

    Joint positions are sampled uniformly over the joint ranges (full ±π for
    unlimited hinges) with the free joint pinned — self-distances are
    base-pose invariant. Conservative in two ways: geom bounding radii
    (geom_rbound) instead of exact shapes, plus the 5 cm safety margin."""
    import mujoco

    d = mujoco.MjData(m)
    rng = np.random.RandomState(seed)
    g1 = np.array([c[0] for c in candidates])
    g2 = np.array([c[1] for c in candidates])
    rsum = m.geom_rbound[g1] + m.geom_rbound[g2] + safety
    min_gap = np.full(len(candidates), np.inf)

    lo = m.jnt_range[:, 0].copy()
    hi = m.jnt_range[:, 1].copy()
    unlimited = ~m.jnt_limited.astype(bool)
    lo[unlimited] = -np.pi
    hi[unlimited] = np.pi
    for _ in range(n_samples):
        d.qpos[:] = m.qpos0
        for j in range(m.njnt):
            if m.jnt_type[j] == HINGE:
                d.qpos[m.jnt_qposadr[j]] = rng.uniform(lo[j], hi[j])
        mujoco.mj_kinematics(m, d)
        gap = np.linalg.norm(d.geom_xpos[g1] - d.geom_xpos[g2], axis=1) - rsum
        np.minimum(min_gap, gap, out=min_gap)
    keep = [c for c, gp in zip(candidates, min_gap) if gp < 0]
    return keep


def extract_model(m, robot: str, scene: str, terrain_limits) -> Model:
    """The port's `Model` of a compiled mjModel: every field the physics
    reads, as the JAX package's `extract_model` copies it (dtypes included), with
    the world-robot and reachable self-collision pairs, the collidable mesh
    hulls and the heightfield."""
    import mujoco

    cfg = get_robot_config(robot)

    def names(kind, n):
        return tuple(
            mujoco.mj_id2name(m, kind, i) or '' for i in range(n))

    body_names = names(mujoco.mjtObj.mjOBJ_BODY, m.nbody)
    jnt_names = names(mujoco.mjtObj.mjOBJ_JOINT, m.njnt)
    geom_names = names(mujoco.mjtObj.mjOBJ_GEOM, m.ngeom)
    site_names = names(mujoco.mjtObj.mjOBJ_SITE, m.nsite)
    cam_names = names(mujoco.mjtObj.mjOBJ_CAMERA, m.ncam)

    # per-leg index tables (the reference's quadruped_env.py:189-204)
    legs_qpos, legs_qvel, legs_tau = [], [], []
    for li, leg in enumerate(LEG_ORDER):
        qpos_idx, qvel_idx, tau_idx = [], [], []
        for jname in cfg.leg_joint_names()[li]:
            jid = jnt_names.index(jname)
            qpos_idx.append(int(m.jnt_qposadr[jid]))
            qvel_idx.append(int(m.jnt_dofadr[jid]))
            # actuator acting on this joint
            act = [a for a in range(m.nu)
                   if m.actuator_trntype[a] == mujoco.mjtTrn.mjTRN_JOINT
                   and m.actuator_trnid[a, 0] == jid]
            tau_idx.append(int(act[0]) if act else -1)
        legs_qpos.append(qpos_idx)
        legs_qvel.append(qvel_idx)
        legs_tau.append(tau_idx)

    feet_geom_id = np.array([geom_names.index(g) for g in cfg.feet_geom_names], np.int32)
    feet_body_id = m.geom_bodyid[feet_geom_id].astype(np.int32)
    hip_body_id = np.array(
        [body_names.index(f'{leg}_hip') if f'{leg}_hip' in body_names else -1
         for leg in LEG_ORDER], np.int32)
    imu_site_id = site_names.index(cfg.imu_site_name) if (
        cfg.imu_site_name in site_names) else -1

    # Static candidate contact pairs, collidable mesh geoms among them (the
    # narrow phase dispatches per type pair).
    # (a) world geoms × robot geoms (stored world-first), MuJoCo's
    #     contype/conaffinity compatibility test.
    pairs = []
    for gw in range(m.ngeom):
        if m.geom_bodyid[gw] != 0:
            continue
        for gr in range(m.ngeom):
            if m.geom_bodyid[gr] == 0:
                continue
            compat = (m.geom_contype[gw] & m.geom_conaffinity[gr]) or \
                     (m.geom_contype[gr] & m.geom_conaffinity[gw])
            if compat:
                pairs.append((gw, gr))
    # (b) robot-robot (self-collision) pairs, MuJoCo's mj_collision filter:
    #     skip same body and parent-child bodies (filterparent default),
    #     contype/conaffinity mask. Stored with geom_type[g1] <= geom_type[g2]
    #     so the narrow phase dispatches on a canonical type order.
    #     Statically unreachable pairs are pruned (shapes must stay static, so
    #     MuJoCo's dynamic broadphase becomes a build-time reachability test):
    #     sample joint configurations over the joint ranges and drop pairs
    #     whose bounding spheres never come within 5 cm across all samples.
    self_candidates = []
    for ga in range(m.ngeom):
        ba = int(m.geom_bodyid[ga])
        if ba == 0:
            continue
        for gb in range(ga + 1, m.ngeom):
            bb = int(m.geom_bodyid[gb])
            if bb == 0 or ba == bb:
                continue
            if int(m.body_parentid[ba]) == bb or int(m.body_parentid[bb]) == ba:
                continue
            compat = (m.geom_contype[ga] & m.geom_conaffinity[gb]) or \
                     (m.geom_contype[gb] & m.geom_conaffinity[ga])
            if not compat:
                continue
            if int(m.geom_type[ga]) <= int(m.geom_type[gb]):
                self_candidates.append((ga, gb))
            else:
                self_candidates.append((gb, ga))
    if self_candidates:
        reachable = _reachable_pairs(m, self_candidates)
        pairs.extend(reachable)
    contact_pairs = np.array(pairs, np.int32).reshape(-1, 2)

    # Convex hulls of the collidable mesh geoms: hull vertices and the
    # mesh_graph adjacency lists, padded to (nmesh, Vmax, *).
    used_meshes = sorted({int(m.geom_dataid[g]) for g in range(m.ngeom)
                          if m.geom_type[g] == GEOM_MESH
                          and (m.geom_contype[g] or m.geom_conaffinity[g])})
    mesh_id_map = {mid: k for k, mid in enumerate(used_meshes)}
    hulls = []
    for mid in used_meshes:
        adr = int(m.mesh_graphadr[mid])
        if adr < 0:
            raise ValueError(f'mesh {mid} has no convex-hull graph')
        graph = m.mesh_graph[adr:]
        numvert = int(graph[0])
        vert_edgeadr = graph[2:2 + numvert]
        vert_globalid = graph[2 + numvert:2 + 2 * numvert]
        edge_localid = graph[2 + 2 * numvert:]
        vadr = int(m.mesh_vertadr[mid])
        verts = np.asarray(m.mesh_vert[vadr + vert_globalid], np.float64)
        nbrs = []
        for i in range(numvert):
            adj = []
            j = int(vert_edgeadr[i])
            while edge_localid[j] >= 0:
                adj.append(int(edge_localid[j]))
                j += 1
            nbrs.append(adj)
        hulls.append((verts, nbrs))
    if hulls:
        vmax = max(len(v) for v, _ in hulls)
        dmax = max((len(a) for _, ns in hulls for a in ns), default=1)
        mesh_vert = np.zeros((len(hulls), vmax, 3))
        mesh_vertnum = np.zeros(len(hulls), np.int32)
        mesh_nbr = np.full((len(hulls), vmax, dmax), -1, np.int32)
        for k, (verts, nbrs) in enumerate(hulls):
            mesh_vert[k, :len(verts)] = verts
            mesh_vertnum[k] = len(verts)
            for i, adj in enumerate(nbrs):
                mesh_nbr[k, i, :len(adj)] = adj
    else:
        mesh_vert = np.zeros((0, 0, 3))
        mesh_vertnum = np.zeros(0, np.int32)
        mesh_nbr = np.zeros((0, 0, 0), np.int32)
    # geom_dataid remapped into the compact hull table (-1 = no hull)
    geom_dataid = np.full(m.ngeom, -1, np.int32)
    for g in range(m.ngeom):
        if m.geom_type[g] == GEOM_MESH:
            geom_dataid[g] = mesh_id_map.get(int(m.geom_dataid[g]), -1)

    nkey = max(m.nkey, 0)
    if m.nhfield > 0:
        hf_size = m.hfield_size[0].copy()
        hf_nrow, hf_ncol = int(m.hfield_nrow[0]), int(m.hfield_ncol[0])
        hf_data = m.hfield_data.reshape(hf_nrow, hf_ncol).copy()
    else:
        hf_size = np.zeros(4)
        hf_nrow = hf_ncol = 0
        hf_data = np.zeros((0, 0))

    return Model(
        robot=robot, scene=scene, hip_height=float(cfg.hip_height),
        terrain_limits=tuple(float(x) for x in terrain_limits),
        nq=int(m.nq), nv=int(m.nv), nu=int(m.nu), nbody=int(m.nbody),
        njnt=int(m.njnt), ngeom=int(m.ngeom), nsite=int(m.nsite),
        timestep=float(m.opt.timestep), gravity=m.opt.gravity.copy(),
        cone=int(m.opt.cone), impratio=float(m.opt.impratio),
        body_parentid=m.body_parentid.astype(np.int32),
        body_jntadr=m.body_jntadr.astype(np.int32),
        body_jntnum=m.body_jntnum.astype(np.int32),
        body_dofadr=m.body_dofadr.astype(np.int32),
        body_dofnum=m.body_dofnum.astype(np.int32),
        body_geomadr=m.body_geomadr.astype(np.int32),
        body_geomnum=m.body_geomnum.astype(np.int32),
        body_pos=m.body_pos.copy(), body_quat=m.body_quat.copy(),
        body_ipos=m.body_ipos.copy(), body_iquat=m.body_iquat.copy(),
        body_mass=m.body_mass.copy(), body_inertia=m.body_inertia.copy(),
        body_invweight0=m.body_invweight0.copy(),
        jnt_type=m.jnt_type.astype(np.int32),
        jnt_qposadr=m.jnt_qposadr.astype(np.int32),
        jnt_dofadr=m.jnt_dofadr.astype(np.int32),
        jnt_bodyid=m.jnt_bodyid.astype(np.int32),
        jnt_limited=m.jnt_limited.astype(bool),
        jnt_pos=m.jnt_pos.copy(), jnt_axis=m.jnt_axis.copy(),
        jnt_range=m.jnt_range.copy(), jnt_stiffness=m.jnt_stiffness.copy(),
        jnt_solref=m.jnt_solref.copy(), jnt_solimp=m.jnt_solimp.copy(),
        jnt_margin=m.jnt_margin.copy(),
        dof_bodyid=m.dof_bodyid.astype(np.int32),
        dof_jntid=m.dof_jntid.astype(np.int32),
        dof_parentid=m.dof_parentid.astype(np.int32),
        dof_armature=m.dof_armature.copy(), dof_damping=m.dof_damping.copy(),
        dof_frictionloss=m.dof_frictionloss.copy(),
        dof_invweight0=m.dof_invweight0.copy(),
        dof_solref=m.dof_solref.copy(), dof_solimp=m.dof_solimp.copy(),
        geom_type=m.geom_type.astype(np.int32),
        geom_bodyid=m.geom_bodyid.astype(np.int32),
        geom_contype=m.geom_contype.astype(np.int32),
        geom_conaffinity=m.geom_conaffinity.astype(np.int32),
        geom_condim=m.geom_condim.astype(np.int32),
        geom_priority=m.geom_priority.astype(np.int32),
        geom_pos=m.geom_pos.copy(), geom_quat=m.geom_quat.copy(),
        geom_size=m.geom_size.copy(), geom_friction=m.geom_friction.copy(),
        geom_solmix=m.geom_solmix.copy(), geom_solref=m.geom_solref.copy(),
        geom_solimp=m.geom_solimp.copy(), geom_margin=m.geom_margin.copy(),
        geom_gap=m.geom_gap.copy(),
        site_bodyid=m.site_bodyid.astype(np.int32),
        site_pos=m.site_pos.copy(), site_quat=m.site_quat.copy(),
        cam_bodyid=m.cam_bodyid.astype(np.int32),
        cam_pos=m.cam_pos.copy(), cam_quat=m.cam_quat.copy(),
        cam_fovy=m.cam_fovy.copy(),
        actuator_trnid=m.actuator_trnid[:, 0].astype(np.int32),
        actuator_gear=m.actuator_gear[:, 0].copy(),
        actuator_ctrlrange=m.actuator_ctrlrange.copy(),
        actuator_ctrllimited=m.actuator_ctrllimited.astype(bool),
        actuator_forcerange=m.actuator_forcerange.copy(),
        actuator_forcelimited=m.actuator_forcelimited.astype(bool),
        qpos0=m.qpos0.copy(), qpos_spring=m.qpos_spring.copy(),
        key_qpos=m.key_qpos.reshape(nkey, m.nq).copy(),
        key_qvel=m.key_qvel.reshape(nkey, m.nv).copy(),
        key_ctrl=m.key_ctrl.reshape(nkey, m.nu).copy(),
        hfield_size=hf_size, hfield_nrow=hf_nrow, hfield_ncol=hf_ncol,
        hfield_data=hf_data,
        body_names=body_names, jnt_names=jnt_names,
        geom_names=geom_names, site_names=site_names, cam_names=cam_names,
        feet_geom_id=feet_geom_id, feet_body_id=feet_body_id,
        legs_qpos_idx=np.array(legs_qpos, np.int32),
        legs_qvel_idx=np.array(legs_qvel, np.int32),
        legs_tau_idx=np.array(legs_tau, np.int32),
        hip_body_id=hip_body_id, imu_site_id=int(imu_site_id),
        contact_pairs=contact_pairs,
        geom_dataid=geom_dataid, geom_rbound=m.geom_rbound.copy(),
        mesh_vert=mesh_vert, mesh_vertnum=mesh_vertnum, mesh_nbr=mesh_nbr,
    )
