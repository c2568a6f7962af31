"""Build one CUDA source of the port into a shared library with a plain C
interface, for ctypes.

Each kernel's module calls `build_library(source)` at its first launch (or
from its own `build()`): nvcc compiles the source for sm_90a into
build/kernels/ at the repository root, under a name that hashes the source
and the flags, so an edited source is rebuilt and an unchanged one is not.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA toolkit')
    return path


def build_library(source: Path) -> tuple[Path, float, str]:
    """Compile `source` for sm_90a if its library is missing. Returns
    (library path, seconds spent, nvcc's output)."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f'lib{source.stem}_{tag}.so'
    if lib.exists():
        return lib, 0.0, ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed on {source.name} ({proc.returncode}):\n'
                           f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0, proc.stdout + proc.stderr
