"""Fused Newton contact solve: the CUDA kernel's wrapper.

The constraint solver's whole Newton loop (rows, forces, Hessian, Cholesky,
line search, stopping test) for B envs in one launch of the kernel of
csrc/newton_fused.cu. Two entry points launch the same kernel and differ
only in the stopping rule:

  * `solve_batched`: each env stops once its accepted step falls below
    tol (1 + |qacc|_inf), tol = 1e-6 in f32, and keeps that step, as
    `physics.solver.solve` does (the physics step's Newton stage);
  * `solve_batched_bt`: exactly `iterations` iterations (tol = 0).

Both take M (B, nv, nv), a_smooth (B, nv), the `Efc` rows and an optional
warm start (B, nv) (None starts from a_smooth), and return (qacc (B, nv),
f_simple (B, ns), f_cone (B, C, 6), qfrc_constraint (B, nv)).

On CPU tensors they run the plain version, `physics.solver.solve` (any float
dtype). On CUDA tensors they launch the kernel (f32, nv <= 32, ns <= 64,
C <= 32, contiguous, one device) or raise; they never fall back. The kernel
is built with nvcc at first use (or by `build()`) under build/kernels/ and
loaded with ctypes. `launches` counts its launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from gym_quadruped_tpu_torch.ops.nvcc import build_library
from gym_quadruped_tpu_torch.physics import solver
from gym_quadruped_tpu_torch.physics.constraints import Efc

MAX_NV = 32
MAX_NS = 64
MAX_C = 32
SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'newton_fused.cu'

launches = 0   # kernel launches since the count was last set to 0
_lib = None

# the Efc fields the kernel reads, in the C entry point's order
EFC_FLOAT_FIELDS = ('J', 'aref', 'R', 'frictionloss', 'con_J', 'con_aref', 'con_R',
                    'cone_mu', 'cone_dim_mask')
EFC_MASK_FIELDS = ('active', 'con_active')


def build() -> tuple[Path, float, str]:
    """Compile csrc/newton_fused.cu for sm_90a if its library is missing.
    Returns (library path, seconds spent, nvcc's output)."""
    return build_library(SOURCE)


def _library():
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        fn = lib.gqt_newton_fused_f32
        fn.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_kernel_inputs(M, a_smooth, efc: Efc, warmstart=None, iterations_out=None):
    """Raise ValueError for inputs the CUDA kernel does not take."""
    floats = {'M': M, 'a_smooth': a_smooth, **{k: getattr(efc, k) for k in EFC_FLOAT_FIELDS}}
    if warmstart is not None:
        floats['warmstart'] = warmstart
    masks = {k: getattr(efc, k) for k in EFC_MASK_FIELDS}
    for name, x in floats.items():
        if x.dtype != torch.float32:
            raise ValueError(f'the Newton kernel takes float32, got {name} {x.dtype}')
    for name, x in masks.items():
        if x.dtype != torch.bool:
            raise ValueError(f'the Newton kernel takes bool masks, got {name} {x.dtype}')
    B, nv = a_smooth.shape
    if iterations_out is not None and (iterations_out.dtype != torch.int32
                                       or iterations_out.shape != (B,)):
        raise ValueError(f'iterations_out must be int32 ({B},), got '
                         f'{iterations_out.dtype} {tuple(iterations_out.shape)}')
    ns, C = efc.J.shape[1], efc.con_J.shape[1]
    if nv > MAX_NV:
        raise ValueError(f'the Newton kernel takes nv <= {MAX_NV}, got nv={nv}')
    if ns > MAX_NS:
        raise ValueError(f'the Newton kernel takes ns <= {MAX_NS} simple rows, got ns={ns}')
    if C > MAX_C:
        raise ValueError(f'the Newton kernel takes C <= {MAX_C} cone blocks, got C={C}')
    tensors = {**floats, **masks}
    if iterations_out is not None:
        tensors['iterations_out'] = iterations_out
    shapes = {'M': (B, nv, nv), 'warmstart': (B, nv), 'J': (B, ns, nv), 'aref': (B, ns),
              'R': (B, ns), 'frictionloss': (B, ns), 'active': (B, ns),
              'con_J': (B, C, 6, nv), 'con_aref': (B, C, 6), 'con_R': (B, C, 6),
              'cone_mu': (B, C, 5), 'cone_dim_mask': (B, C, 6), 'con_active': (B, C)}
    for name, x in tensors.items():
        if name in shapes and tuple(x.shape) != shapes[name]:
            raise ValueError(f'the Newton kernel expected {name} {shapes[name]}, '
                             f'got {tuple(x.shape)}')
        if not x.is_contiguous():
            raise ValueError(f'the Newton kernel takes contiguous tensors, {name} is not')
    devices = {x.device for x in tensors.values()}
    if len(devices) != 1 or M.device.type != 'cuda':
        raise ValueError(f'the Newton kernel takes CUDA tensors on one device, got '
                         f'{sorted(map(str, devices))}')


def _solve(M, a_smooth, efc: Efc, warmstart, iterations, ls_iterations, tol,
           iterations_out):
    global launches
    B, nv = a_smooth.shape
    ns, C = efc.J.shape[1], efc.con_J.shape[1]
    tensors = [M, a_smooth, *(getattr(efc, k) for k in EFC_FLOAT_FIELDS + EFC_MASK_FIELDS)]
    tensors += [x for x in (warmstart, iterations_out) if x is not None]
    if all(x.device.type == 'cpu' for x in tensors):
        return solver.solve(M, a_smooth, efc, warmstart, iterations, ls_iterations,
                            iterations_out, _tol=tol)
    check_kernel_inputs(M, a_smooth, efc, warmstart, iterations_out)
    if ns == 0 and C == 0:
        return solver.solve(M, a_smooth, efc, warmstart, iterations, ls_iterations,
                            iterations_out, _tol=tol)
    qacc = torch.empty_like(a_smooth)
    qfrc = torch.empty_like(a_smooth)
    f_simple = a_smooth.new_empty(B, ns)
    f_cone = a_smooth.new_empty(B, C, 6)
    if B == 0:
        return qacc, f_simple, f_cone, qfrc
    a0 = a_smooth if warmstart is None else warmstart
    grid = solver._ls_grid(torch.float32, a_smooth.device)
    ptr = lambda x: x.data_ptr()
    stream = torch.cuda.current_stream(a_smooth.device).cuda_stream
    err = _library().gqt_newton_fused_f32(
        ptr(M), ptr(a_smooth), ptr(a0), ptr(efc.J), ptr(efc.aref), ptr(efc.R),
        ptr(efc.active), ptr(efc.frictionloss), ptr(efc.con_J), ptr(efc.con_aref),
        ptr(efc.con_R), ptr(efc.con_active), ptr(efc.cone_mu), ptr(efc.cone_dim_mask),
        ptr(grid), ptr(qacc), ptr(f_simple), ptr(f_cone), ptr(qfrc),
        None if iterations_out is None else ptr(iterations_out),
        B, nv, ns, C, iterations, ls_iterations, tol, stream)
    if err != 0:
        raise RuntimeError(f'newton_fused kernel launch failed: CUDA error {err}')
    launches += 1
    return qacc, f_simple, f_cone, qfrc


def solve_batched(M, a_smooth, efc: Efc, warmstart=None, iterations: int = 10,
                  ls_iterations: int = 6, iterations_out=None):
    """Newton solve with the per-env stopping rule of `solver.solve`.
    `iterations_out`, an int32 (B,) tensor, receives each env's count of
    Newton iterations."""
    tol = solver._TOL.get(a_smooth.dtype, 1e-6)
    return _solve(M, a_smooth, efc, warmstart, iterations, ls_iterations, tol,
                  iterations_out)


def solve_batched_bt(M, a_smooth, efc: Efc, warmstart=None, iterations: int = 10,
                     iterations_out=None):
    """Newton solve of exactly `iterations` iterations for every env."""
    return _solve(M, a_smooth, efc, warmstart, iterations, 6, 0.0, iterations_out)
