"""Build one CUDA source of the port into a shared library with a plain C
interface, for ctypes.

Each kernel's module calls `build_library(source, defines)` at its first
launch at a size (or from its own `build(n)`): nvcc compiles the source for
sm_90a with the size as a macro (`-DGQT_NV=18`), so every loop over it has a
trip count known at compile time, into build/kernels/ at the repository
root, under a name that hashes the source, every header (`*.cuh`) beside
it, the flags and the macros: an edited source or header, or another size,
is built anew, and an unchanged one is not.
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


def _flags(defines: tuple[str, ...]) -> list[str]:
    return NVCC_FLAGS + [f'-D{d}' for d in defines]


def library_tag(source: Path, defines: tuple[str, ...] = ()) -> str:
    """Hash of the source, of every `*.cuh` in its directory (by name, then
    bytes), of the flags and of the macros (`NAME=value`): the build's name
    changes with any of them."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob('*.cuh')):
        h.update(header.name.encode() + b'\0' + header.read_bytes())
    h.update(' '.join(_flags(defines)).encode())
    return h.hexdigest()[:12]


def build_library(source: Path, defines: tuple[str, ...] = ()) -> tuple[Path, float, str]:
    """Compile `source` for sm_90a with the macros `defines` if its library
    is missing. Returns (library path, seconds spent, nvcc's output)."""
    lib = BUILD_DIR / f'lib{source.stem}_{library_tag(source, defines)}.so'
    if lib.exists():
        return lib, 0.0, ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *_flags(defines), '-o', str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed on {source.name} ({proc.returncode}):\n'
                           f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0, proc.stdout + proc.stderr
