"""The port's fused Newton solve wrapper against the JAX package's solvers,
on spot/flat and go2/flat contact states in f64.

* `newton_fused.solve_batched` (per-env stopping, the counterpart of the
  fused gen-1 kernel) against the reference's vmapped `solve`, from a_smooth
  and from a warm start: 1e-9.
* `newton_fused.solve_batched_bt` (a fixed iteration count, the counterpart
  of the fused gen-2 kernel) against the reference's `solve_batched`, the
  XLA twin of that kernel: 1e-9.
* CPU tensors take the plain version and count no launch; the card path
  checks its inputs before it builds or launches anything.
* The premise of the kernel's row compaction, in f64: on spot/flat states
  with active and inactive joint-limit rows and cone blocks, the plain
  solve of each env on its full rows and on its active rows alone give the
  same qacc and qfrc to 1e-12 and the same iteration count, and the full
  solve's forces on the inactive rows are exactly 0.

The CUDA kernel itself is held against the plain version in
tests/test_torch_card.py and chip_smoke.py. The Pallas kernels are not run
here: in interpret mode each takes tens of seconds.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gym_quadruped_tpu.models.builder import load_model as jload
from gym_quadruped_tpu.physics import constraints as jcon
from gym_quadruped_tpu.physics import engine as jeng
from gym_quadruped_tpu.physics import solver as jsol
from gym_quadruped_tpu_torch.models.model import load_model as pload
from gym_quadruped_tpu_torch.ops import newton_fused as nf
from gym_quadruped_tpu_torch.physics import constraints as pcon
from gym_quadruped_tpu_torch.physics import engine as peng
from gym_quadruped_tpu_torch.physics import solver as psol
from test_torch_step import _contact_state

B = 4


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spot_rows():
    """M, a_smooth and the constraint rows of B spot/flat contact states, as
    the reference's batched Efc and as the port's tensors."""
    jm = jload('spot', 'flat')
    qpos, qvel, ctrl = _contact_state(jm, B, seed=41)
    pre = jax.jit(lambda q, v, c: jeng._pre_solve(jm, q, v, c,
                                                  max_cone=jeng.MAX_CONE_CONTACTS))
    outs = [pre(q, v, c) for q, v, c in zip(qpos, qvel, ctrl)]
    M = np.stack([np.asarray(o[2]) for o in outs])
    a_smooth = np.stack([np.asarray(o[7]) for o in outs])
    jefc = jax.tree_util.tree_map(lambda *x: np.stack(x), *[o[9] for o in outs])
    efc = pcon.Efc(**{k.name: torch.as_tensor(np.asarray(getattr(jefc, k.name)))
                      for k in dataclasses.fields(pcon.Efc)
                      if getattr(jefc, k.name) is not None})
    assert bool(efc.con_active.any())
    return jm, M, a_smooth, jefc, efc


def _go2_rows():
    """The same for B go2/flat contact states, at go2's shapes (ns 24, C 32
    culled from 1,180 cone slots, condim 3 and 6 blocks both active). The
    rows come from the port's f64 forward (held against the reference's in
    tests/test_torch_step_go2.py) and go to both solvers."""
    jm = jload('go2', 'flat')
    dm = pload('go2', 'flat', device='cpu', dtype=torch.float64)
    qpos, qvel, ctrl = _contact_state(jm, B, seed=41)
    fwd = peng.forward(dm, *(torch.as_tensor(x) for x in (qpos, qvel, ctrl)))
    efc = fwd.efc
    assert efc.J.shape[1:] == (24, 18) and efc.con_J.shape[1] == 32
    dims = efc.cone_dim_mask.sum(-1)[efc.con_active]
    assert bool((dims == 3).any()) and bool((dims == 6).any())
    jefc = jcon.Efc(**{k.name: getattr(efc, k.name).numpy() for k in dataclasses.fields(pcon.Efc)
                       if getattr(efc, k.name) is not None})
    return jm, fwd.M.numpy(), fwd.qacc_smooth.numpy(), jefc, efc


@pytest.fixture(scope='module')
def rows_of():
    """robot -> (jm, M, a_smooth, reference Efc, port Efc), made once."""
    made = {}

    def get(robot):
        if robot not in made:
            made[robot] = {'spot': _spot_rows, 'go2': _go2_rows}[robot]()
        return made[robot]
    return get


@pytest.fixture(scope='module')
def rows(rows_of):
    return rows_of('spot')


def _close(got, ref, name):
    ref = np.asarray(ref)
    scale = 1 + np.abs(ref).max(initial=0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-9 * scale, err_msg=name)


@pytest.mark.parametrize('robot,warm', [
    pytest.param('spot', False, id='False'), pytest.param('spot', True, id='True'),
    pytest.param('go2', False, id='go2-False'), pytest.param('go2', True, id='go2-True')])
def test_solve_batched_matches_vmapped_solve(rows_of, robot, warm):
    jm, M, a_smooth, jefc, efc = rows_of(robot)
    lay = jcon.constraint_layout(jm)
    w = np.random.RandomState(42).randn(*a_smooth.shape) if warm else a_smooth
    ref = jax.jit(jax.vmap(lambda M_, a, e, w_: jsol.solve(jm, lay, M_, a, e, warmstart=w_)))(
        M, a_smooth, jefc, w)
    got = nf.solve_batched(torch.as_tensor(M), torch.as_tensor(a_smooth), efc,
                           warmstart=torch.as_tensor(w) if warm else None)
    for g, r, name in zip(got, ref, ('qacc', 'f_simple', 'f_cone', 'qfrc')):
        _close(g, r, name)


def _check_bt(jm, M, a_smooth, jefc, efc):
    lay = jcon.constraint_layout(jm)
    ref = jax.jit(lambda M_, a, e: jsol.solve_batched(jm, lay, M_, a, e))(M, a_smooth, jefc)
    got = nf.solve_batched_bt(torch.as_tensor(M), torch.as_tensor(a_smooth), efc)
    for g, r, name in zip(got, ref, ('qacc', 'f_simple', 'f_cone', 'qfrc')):
        _close(g, r, name)


def test_solve_batched_bt_matches_reference_solve_batched(rows):
    _check_bt(*rows)


def test_solve_batched_bt_matches_reference_solve_batched_go2(rows_of):
    _check_bt(*rows_of('go2'))


def test_cpu_routes_to_plain_and_counts_no_launch(rows):
    _, M, a_smooth, _, efc = rows
    M, a_smooth = torch.as_tensor(M), torch.as_tensor(a_smooth)
    before = nf.launches
    it = torch.zeros(B, dtype=torch.int32)
    got = nf.solve_batched(M, a_smooth, efc, iterations_out=it)
    it_bt = torch.zeros(B, dtype=torch.int32)
    got_bt = nf.solve_batched_bt(M, a_smooth, efc, iterations=7, iterations_out=it_bt)
    assert nf.launches == before
    for g, r in zip(got, psol.solve(M, a_smooth, efc)):
        assert torch.equal(g, r)
    for g, r in zip(got_bt, psol.solve(M, a_smooth, efc, iterations=7, _tol=0.0)):
        assert torch.equal(g, r)
    # per-env stopping ends within the cap; the fixed count runs every env
    assert bool(((it >= 1) & (it <= 10)).all())
    assert it_bt.tolist() == [7] * B


SIMPLE_FIELDS = ('J', 'aref', 'R', 'active', 'frictionloss')
CONE_FIELDS = ('con_J', 'con_aref', 'con_R', 'con_active', 'cone_mu', 'cone_dim_mask',
               'cone_dist', 'cone_sel')


@pytest.fixture(scope='module')
def limit_rows():
    """M, a_smooth and the rows of 6 soft spot/flat states in f64 (the
    keyframe lowered up to 5 mm, qvel 0, small torques), with the first
    limited joint (a hip) of every other env 0.01 rad past its range."""
    B = 6
    dm = pload('spot', 'flat', device='cpu', dtype=torch.float64)
    m = dm.m
    rng = np.random.RandomState(7)
    qpos = np.tile(m.key_qpos[0], (B, 1))
    qpos[:, 2] -= rng.uniform(0, 0.005, B)
    j = pcon.constraint_layout(m).lim_jnts[0]
    qpos[::2, m.jnt_qposadr[j]] = m.jnt_range[j, 1] + 0.01
    ctrl = rng.uniform(-0.5, 0.5, (B, m.nu))
    fwd = peng.forward(dm, torch.as_tensor(qpos), torch.zeros(B, m.nv, dtype=torch.float64),
                       torch.as_tensor(ctrl))
    efc = fwd.efc
    # both kinds of row are there: active and inactive limits, active and
    # inactive cone blocks
    for mask in (efc.active, efc.con_active):
        assert bool(mask.any()) and not bool(mask.all())
    assert bool(efc.active[::2].sum(1).gt(efc.active[1::2].sum(1)).all())
    return fwd.M, fwd.qacc_smooth, efc


def _env_rows(efc, e, compact):
    """Env e's rows (batch of 1): all of them, or only its active simple rows
    and cone blocks, in their order."""
    s = efc.active[e].nonzero()[:, 0] if compact else slice(None)
    c = efc.con_active[e].nonzero()[:, 0] if compact else slice(None)
    rows = {k: getattr(efc, k)[e:e + 1, s] for k in SIMPLE_FIELDS}
    rows.update({k: getattr(efc, k)[e:e + 1, c] for k in CONE_FIELDS})
    return pcon.Efc(**{k: v.contiguous() for k, v in rows.items()})


@pytest.mark.parametrize('start', ['a_smooth', 'zeros'])
def test_inactive_rows_change_nothing(limit_rows, start):
    M, a_smooth, efc = limit_rows
    for e in range(a_smooth.shape[0]):
        M_e, a_e = M[e:e + 1], a_smooth[e:e + 1]
        warm = None if start == 'a_smooth' else torch.zeros_like(a_e)
        it_full, it_act = (torch.zeros(1, dtype=torch.int32) for _ in range(2))
        full = psol.solve(M_e, a_e, _env_rows(efc, e, False), warm, iterations_out=it_full)
        act = psol.solve(M_e, a_e, _env_rows(efc, e, True), warm, iterations_out=it_act)
        scale = 1 + full[0].abs().max().item()
        for i, name in ((0, 'qacc'), (3, 'qfrc')):
            np.testing.assert_allclose(act[i].numpy(), full[i].numpy(), rtol=0,
                                       atol=1e-12 * scale, err_msg=f'env {e} {name}')
        assert it_act.item() == it_full.item()
        # the dropped rows' forces are exact zeros; the kept ones agree
        assert bool((full[1][0, ~efc.active[e]] == 0).all())
        assert bool((full[2][0, ~efc.con_active[e]] == 0).all())
        np.testing.assert_allclose(act[1].numpy(), full[1][:, efc.active[e]].numpy(),
                                   rtol=0, atol=1e-12 * scale)
        np.testing.assert_allclose(act[2].numpy(), full[2][:, efc.con_active[e]].numpy(),
                                   rtol=0, atol=1e-12 * scale)


def _meta_rows(nv=18, ns=24, C=10, dtype=torch.float32):
    e = lambda *s, dt=dtype: torch.empty(8, *s, dtype=dt, device='meta')
    efc = pcon.Efc(J=e(ns, nv), aref=e(ns), R=e(ns), active=e(ns, dt=torch.bool),
                   frictionloss=e(ns), con_J=e(C, 6, nv), con_aref=e(C, 6), con_R=e(C, 6),
                   con_active=e(C, dt=torch.bool), cone_mu=e(C, 5), cone_dim_mask=e(C, 6),
                   cone_dist=e(C), cone_sel=e(C, dt=torch.int64))
    return e(nv, nv), e(nv), efc


@pytest.mark.parametrize('case,match', [
    ('f64', 'float32'), ('nv33', 'nv <= 32'), ('C33', 'C <= 32'), ('ns1089', 'ns <= 1088'),
    ('strided', 'contiguous'), ('mixed', 'one device'), ('shape', 'expected warmstart'),
    ('iterations_out', 'int32')])
def test_kernel_path_raises_on_inputs_it_does_not_take(case, match):
    # A tensor off the CPU takes the kernel path, which checks its inputs
    # before it builds or launches anything: meta tensors reach it here.
    sizes = {'nv33': {'nv': 33}, 'C33': {'C': 33}, 'ns1089': {'ns': 1089}}.get(case, {})
    dtype = torch.float64 if case == 'f64' else torch.float32
    M, a_smooth, efc = _meta_rows(dtype=dtype, **sizes)
    kwargs = {}
    if case == 'strided':
        M = M.transpose(1, 2)
    elif case == 'mixed':
        kwargs['warmstart'] = torch.zeros(8, 18)
    elif case == 'shape':
        kwargs['warmstart'] = torch.empty(8, 17, device='meta')
    elif case == 'iterations_out':
        kwargs['iterations_out'] = torch.empty(8, dtype=torch.int64, device='meta')
    for solve in (nf.solve_batched, nf.solve_batched_bt):
        with pytest.raises(ValueError, match=match):
            solve(M, a_smooth, efc, **kwargs)
