"""The port's fused Newton solve wrapper against the JAX package's solvers,
on spot/flat contact states in f64.

* `newton_fused.solve_batched` (per-env stopping, the counterpart of the
  fused gen-1 kernel) against the reference's vmapped `solve`, from a_smooth
  and from a warm start: 1e-9.
* `newton_fused.solve_batched_bt` (a fixed iteration count, the counterpart
  of the fused gen-2 kernel) against the reference's `solve_batched`, the
  XLA twin of that kernel: 1e-9.
* CPU tensors take the plain version and count no launch; the card path
  checks its inputs before it builds or launches anything.

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
from gym_quadruped_tpu_torch.ops import newton_fused as nf
from gym_quadruped_tpu_torch.physics import constraints as pcon
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


@pytest.fixture(scope='module')
def rows():
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
                      for k in dataclasses.fields(pcon.Efc)})
    assert bool(efc.con_active.any())
    return jm, M, a_smooth, jefc, efc


def _close(got, ref, name):
    ref = np.asarray(ref)
    scale = 1 + np.abs(ref).max(initial=0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-9 * scale, err_msg=name)


@pytest.mark.parametrize('warm', [False, True])
def test_solve_batched_matches_vmapped_solve(rows, warm):
    jm, M, a_smooth, jefc, efc = rows
    lay = jcon.constraint_layout(jm)
    w = np.random.RandomState(42).randn(*a_smooth.shape) if warm else a_smooth
    ref = jax.jit(jax.vmap(lambda M_, a, e, w_: jsol.solve(jm, lay, M_, a, e, warmstart=w_)))(
        M, a_smooth, jefc, w)
    got = nf.solve_batched(torch.as_tensor(M), torch.as_tensor(a_smooth), efc,
                           warmstart=torch.as_tensor(w) if warm else None)
    for g, r, name in zip(got, ref, ('qacc', 'f_simple', 'f_cone', 'qfrc')):
        _close(g, r, name)


def test_solve_batched_bt_matches_reference_solve_batched(rows):
    jm, M, a_smooth, jefc, efc = rows
    lay = jcon.constraint_layout(jm)
    ref = jax.jit(lambda M_, a, e: jsol.solve_batched(jm, lay, M_, a, e))(M, a_smooth, jefc)
    got = nf.solve_batched_bt(torch.as_tensor(M), torch.as_tensor(a_smooth), efc)
    for g, r, name in zip(got, ref, ('qacc', 'f_simple', 'f_cone', 'qfrc')):
        _close(g, r, name)


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


def _meta_rows(nv=18, ns=24, C=10, dtype=torch.float32):
    e = lambda *s, dt=dtype: torch.empty(8, *s, dtype=dt, device='meta')
    efc = pcon.Efc(J=e(ns, nv), aref=e(ns), R=e(ns), active=e(ns, dt=torch.bool),
                   frictionloss=e(ns), con_J=e(C, 6, nv), con_aref=e(C, 6), con_R=e(C, 6),
                   con_active=e(C, dt=torch.bool), cone_mu=e(C, 5), cone_dim_mask=e(C, 6),
                   cone_dist=e(C), cone_sel=e(C, dt=torch.int64))
    return e(nv, nv), e(nv), efc


@pytest.mark.parametrize('case,match', [
    ('f64', 'float32'), ('nv33', 'nv <= 32'), ('C33', 'C <= 32'), ('ns65', 'ns <= 64'),
    ('strided', 'contiguous'), ('mixed', 'one device'), ('shape', 'expected warmstart'),
    ('iterations_out', 'int32')])
def test_kernel_path_raises_on_inputs_it_does_not_take(case, match):
    # A tensor off the CPU takes the kernel path, which checks its inputs
    # before it builds or launches anything: meta tensors reach it here.
    sizes = {'nv33': {'nv': 33}, 'C33': {'C': 33}, 'ns65': {'ns': 65}}.get(case, {})
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
