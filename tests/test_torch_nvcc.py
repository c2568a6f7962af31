"""The kernel build's name: a hash of the source, of every header beside it,
of nvcc's flags and of the size macro, so that an edited source or header,
or another size, is built anew and an unchanged one is not. No nvcc is
needed: nothing here compiles."""

from pathlib import Path

import pytest

from gym_quadruped_tpu_torch.ops import newton_fused as nf
from gym_quadruped_tpu_torch.ops import nvcc
from gym_quadruped_tpu_torch.ops import spd_solve as spd


@pytest.fixture
def csrc(tmp_path):
    d = tmp_path / 'csrc'
    d.mkdir()
    (d / 'kernel.cu').write_text('#include "shared.cuh"\n__global__ void k() {}\n')
    (d / 'shared.cuh').write_text('// v1\n')
    return d


@pytest.mark.parametrize('edit', ['header', 'source', 'new header', 'flags', 'size'])
def test_tag_changes_with_sources_headers_and_flags(csrc, monkeypatch, edit):
    source = csrc / 'kernel.cu'
    before = nvcc.library_tag(source, ('GQT_NV=18',))
    assert nvcc.library_tag(source, ('GQT_NV=18',)) == before   # nothing changed
    if edit == 'size':
        assert nvcc.library_tag(source, ('GQT_NV=12',)) != before
        return
    if edit == 'header':
        (csrc / 'shared.cuh').write_text('// v2\n')
    elif edit == 'source':
        source.write_text(source.read_text() + '// edited\n')
    elif edit == 'new header':
        (csrc / 'other.cuh').write_text('')
    else:
        monkeypatch.setattr(nvcc, 'NVCC_FLAGS', nvcc.NVCC_FLAGS + ['-lineinfo'])
    assert nvcc.library_tag(source, ('GQT_NV=18',)) != before


def test_tag_follows_content_not_time(csrc):
    source, header = csrc / 'kernel.cu', csrc / 'shared.cuh'
    before = nvcc.library_tag(source)
    header.write_text('// v2\n')
    header.write_text('// v1\n')
    assert nvcc.library_tag(source) == before


def test_existing_library_is_not_rebuilt(csrc, tmp_path, monkeypatch):
    # with the tagged library present, build_library returns it without nvcc
    monkeypatch.setattr(nvcc, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(nvcc, '_nvcc', lambda: pytest.fail('nvcc was called'))
    source = csrc / 'kernel.cu'
    lib = nvcc.BUILD_DIR / f'libkernel_{nvcc.library_tag(source)}.so'
    lib.parent.mkdir()
    lib.write_bytes(b'')
    assert nvcc.build_library(source) == (lib, 0.0, '')


def test_port_kernels_share_the_cholesky_header():
    # both kernels include csrc/chol_warp.cuh, so its bytes are in both tags
    header = Path(spd.SOURCE).parent / 'chol_warp.cuh'
    assert header.exists()
    for source in (spd.SOURCE, nf.SOURCE):
        assert '#include "chol_warp.cuh"' in source.read_text()
    assert nvcc.library_tag(spd.SOURCE) != nvcc.library_tag(nf.SOURCE)



@pytest.mark.parametrize('module,macro', [(spd, 'GQT_N'), (nf, 'GQT_NV')])
def test_each_size_is_its_own_build(module, macro, tmp_path, monkeypatch):
    # build(n) names its library by the size macro: with the libraries of
    # two sizes present, each size gets its own and nvcc is not called
    monkeypatch.setattr(nvcc, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(nvcc, '_nvcc', lambda: pytest.fail('nvcc was called'))
    for n in (18, 12):
        tag = nvcc.library_tag(module.SOURCE, (f'{macro}={n}',))
        (tmp_path / f'lib{module.SOURCE.stem}_{tag}.so').write_bytes(b'')
    libs = {n: module.build(n)[0] for n in (18, 12)}
    assert libs[18] != libs[12]
    assert all(lib.exists() for lib in libs.values())
