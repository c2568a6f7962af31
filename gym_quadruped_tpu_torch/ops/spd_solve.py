"""Batched tiny-SPD linear solve: the CUDA kernel's wrapper and its plain
PyTorch version.

The physics step solves thousands of independent (nv x nv) SPD systems per
call: the smooth dynamics, each Newton iteration of the contact solver, and
the implicit-damping Euler update (nv = 18 for every shipped robot).

`spd_solve_batched(A, b)` takes A (B, n, n) and b (B, n):
  * on CPU tensors it runs `unrolled_chol_solve_torch`, the plain version
    (any float dtype, any n);
  * on CUDA tensors it launches the kernel of csrc/spd_solve.cu (f32,
    n <= 32, contiguous) or raises. It never falls back.

The kernel is built with nvcc into a shared library with a plain C interface,
one for each size n, at that size's first use (or by `build(n)`), under
build/kernels/ at the repository root, and loaded with ctypes. `launches`
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from gym_quadruped_tpu_torch.ops.nvcc import build_library

MAX_N = 32
SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'spd_solve.cu'

launches = 0   # kernel launches since the count was last set to 0
_libs = {}      # n -> the library built for systems of size n


def unrolled_chol_solve_torch(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: (B, n, n), (B, n) -> (B, n).

    The same algorithm as the kernel and as the reference's unrolled solve:
    Cholesky with the pivot clamped to sqrt(max(s, 1e-30)) and a reciprocal
    diagonal, then forward and back substitution, batched over B. It is
    written column by column: each finished column of L is subtracted from
    the trailing block at once, which applies the same subtractions to every
    entry of L and y in the same order as the entry-by-entry loops, in n
    steps of whole-tensor work. Only the back substitution subtracts in the
    opposite order, which changes the last bits."""
    n = b.shape[-1]
    a = A.clone()
    v = b.clone()
    inv = torch.empty_like(b)
    for j in range(n):
        d = torch.sqrt(torch.clamp_min(a[:, j, j], 1e-30))
        inv[:, j] = 1.0 / d
        col = a[:, j + 1:, j] * inv[:, j, None]                # L[j+1:, j]
        a[:, j + 1:, j] = col
        a[:, j + 1:, j + 1:] -= col[:, :, None] * col[:, None, :]
    for i in range(n):                                         # L y = b
        v[:, i] = v[:, i] * inv[:, i]
        v[:, i + 1:] -= a[:, i + 1:, i] * v[:, i, None]
    for i in range(n - 1, -1, -1):                             # L' x = y
        v[:, i] = v[:, i] * inv[:, i]
        v[:, :i] -= a[:, i, :i] * v[:, i, None]
    return v


def build(n: int) -> tuple[Path, float, str]:
    """Compile csrc/spd_solve.cu for sm_90a and systems of size n if its
    library is missing. Returns (library path, seconds spent, nvcc's
    output)."""
    return build_library(SOURCE, (f'GQT_N={n}',))


def _library(n: int):
    lib = _libs.get(n)
    if lib is None:
        path, _, _ = build(n)
        lib = ctypes.CDLL(str(path))
        fn = lib.gqt_spd_solve_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = lib.gqt_spd_solve_occupancy
        occ.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        occ.restype = ctypes.c_int
        _libs[n] = lib
    return lib


def occupancy(n: int) -> tuple[int, int]:
    """(blocks per SM, systems per block) of the kernel at size n, from the
    CUDA occupancy query on the current device."""
    blocks, per_block = ctypes.c_int(), ctypes.c_int()
    err = _library(n).gqt_spd_solve_occupancy(n, ctypes.byref(blocks), ctypes.byref(per_block))
    if err != 0:
        raise RuntimeError(f'spd_solve occupancy query failed: CUDA error {err}')
    return blocks.value, per_block.value


def check_kernel_inputs(A: torch.Tensor, b: torch.Tensor):
    """Raise ValueError for inputs the CUDA kernel does not take."""
    if A.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f'the SPD kernel takes float32, got {A.dtype} and {b.dtype}')
    n = b.shape[-1]
    if n < 1 or n > MAX_N:
        raise ValueError(f'the SPD kernel takes 1 <= n <= {MAX_N}, got n={n}')
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError('the SPD kernel takes contiguous A and b')
    if A.device.type != 'cuda' or b.device != A.device:
        raise ValueError(f'the SPD kernel takes CUDA tensors on one device, '
                         f'got {A.device} and {b.device}')


def spd_solve_batched(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for A (B, n, n) SPD and b (B, n) -> x (B, n)."""
    global launches
    if A.ndim != 3 or b.ndim != 2 or A.shape != (b.shape[0], b.shape[1], b.shape[1]):
        raise ValueError(f'expected A (B, n, n) and b (B, n), got {tuple(A.shape)} '
                         f'and {tuple(b.shape)}')
    if A.device.type == 'cpu' and b.device.type == 'cpu':
        return unrolled_chol_solve_torch(A, b)
    check_kernel_inputs(A, b)
    x = torch.empty_like(b)
    if b.shape[0] == 0:
        return x
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = _library(b.shape[1]).gqt_spd_solve_f32(A.data_ptr(), b.data_ptr(), x.data_ptr(),
                                                 b.shape[0], b.shape[1], stream)
    if err != 0:
        raise RuntimeError(f'spd_solve kernel launch failed: CUDA error {err}')
    launches += 1
    return x


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve one system, A (n, n) and b (n,) -> x (n,)."""
    if A.ndim != 2 or b.ndim != 1:
        raise ValueError(f'expected A (n, n) and b (n,), got {tuple(A.shape)} '
                         f'and {tuple(b.shape)}')
    return spd_solve_batched(A[None].contiguous(), b[None].contiguous())[0]
