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
dtype). On CUDA tensors they launch the kernel (f32, nv <= 32, ns <= 1,088,
C <= 32, contiguous, one device) or raise; they never fall back, not even
with no rows at all (ns = C = 0), where the kernel writes a_smooth as the
plain version does. The kernel is built with nvcc, one library for each nv,
at that nv's first use (or by `build(nv)`) under build/kernels/ and loaded
with ctypes. `launches` counts its launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from gym_quadruped_tpu_torch.ops.nvcc import build_library
from gym_quadruped_tpu_torch.physics import solver
from gym_quadruped_tpu_torch.physics.constraints import Efc

MAX_NV = 32
MAX_NS = 1088
MAX_C = 32
SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'newton_fused.cu'

launches = 0   # kernel launches since the count was last set to 0
_libs = {}      # nv -> the library built for nv dofs

# the Efc fields the kernel reads, in the C entry point's order
EFC_FLOAT_FIELDS = ('J', 'aref', 'R', 'frictionloss', 'con_J', 'con_aref', 'con_R',
                    'cone_mu', 'cone_dim_mask')
EFC_MASK_FIELDS = ('active', 'con_active')


def build(nv: int) -> tuple[Path, float, str]:
    """Compile csrc/newton_fused.cu for sm_90a and nv dofs if its library is
    missing. Returns (library path, seconds spent, nvcc's output)."""
    return build_library(SOURCE, (f'GQT_NV={nv}',))


def _library(nv: int):
    lib = _libs.get(nv)
    if lib is None:
        path, _, _ = build(nv)
        lib = ctypes.CDLL(str(path))
        fn = lib.gqt_newton_fused_f32
        fn.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        occ = lib.gqt_newton_fused_occupancy
        occ.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
        occ.restype = ctypes.c_int
        _libs[nv] = lib
    return lib


def occupancy(nv: int, ns: int, C: int) -> tuple[int, int, int]:
    """(blocks per SM, envs per block, shared-memory bytes per block) of the
    kernel at (nv, ns, C), from the CUDA occupancy query on the current
    device. A block holds two envs where their shared memory fits in one
    block, else one (mini_cheetah/perlin's 1,058 rows)."""
    blocks, per_block, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _library(nv).gqt_newton_fused_occupancy(nv, ns, C, ctypes.byref(blocks),
                                                  ctypes.byref(per_block), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f'newton_fused occupancy query failed: CUDA error {err}')
    return blocks.value, per_block.value, smem.value


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


def kernel_args(M, a_smooth, efc: Efc, a0, outputs, iterations_out, iterations,
                ls_iterations, tol) -> tuple:
    """The C entry point's arguments for checked inputs and the outputs
    (qacc, f_simple, f_cone, qfrc), on the current stream."""
    B, nv = a_smooth.shape
    ns, C = efc.J.shape[1], efc.con_J.shape[1]
    grid = solver._ls_grid(torch.float32, a_smooth.device)
    tensors = (M, a_smooth, a0, efc.J, efc.aref, efc.R, efc.active, efc.frictionloss,
               efc.con_J, efc.con_aref, efc.con_R, efc.con_active, efc.cone_mu,
               efc.cone_dim_mask, grid, *outputs)
    return (*(x.data_ptr() for x in tensors),
            None if iterations_out is None else iterations_out.data_ptr(),
            B, nv, ns, C, iterations, ls_iterations, tol,
            torch.cuda.current_stream(a_smooth.device).cuda_stream)


def _solve(M, a_smooth, efc: Efc, warmstart, iterations, ls_iterations, tol,
           iterations_out):
    global launches
    B = a_smooth.shape[0]
    ns, C = efc.J.shape[1], efc.con_J.shape[1]
    tensors = [M, a_smooth, *(getattr(efc, k) for k in EFC_FLOAT_FIELDS + EFC_MASK_FIELDS)]
    tensors += [x for x in (warmstart, iterations_out) if x is not None]
    if all(x.device.type == 'cpu' for x in tensors):
        return solver.solve(M, a_smooth, efc, warmstart, iterations, ls_iterations,
                            iterations_out, _tol=tol)
    check_kernel_inputs(M, a_smooth, efc, warmstart, iterations_out)
    outputs = (torch.empty_like(a_smooth), a_smooth.new_empty(B, ns),
               a_smooth.new_empty(B, C, 6), torch.empty_like(a_smooth))
    if B == 0:
        return outputs
    a0 = a_smooth if warmstart is None else warmstart
    err = _library(a_smooth.shape[1]).gqt_newton_fused_f32(*kernel_args(
        M, a_smooth, efc, a0, outputs, iterations_out, iterations, ls_iterations, tol))
    if err != 0:
        raise RuntimeError(f'newton_fused kernel launch failed: CUDA error {err}')
    launches += 1
    return outputs


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
