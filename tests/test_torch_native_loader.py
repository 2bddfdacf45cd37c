"""The port's C++ decode pool (gltvae_torch/native/loader.cpp, built by
gltvae_torch.data.native_loader into build/gltvae_torch/) against gltvae's
(native/loader.cpp through gltvae.data.native_loader): byte-equal batches
(tolerance 0). Skips where g++ or jpeglib.h is missing."""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest

import gltvae.config as jcfg
import gltvae.data.celeba as jc
from gltvae.data import native_loader as jn

import gltvae_torch.config as tcfg
import gltvae_torch.data.celeba as tc
from gltvae_torch.data import native_loader as tn
from gltvae_torch.data.synthetic import write_celeba_corpus

ROOT = Path(__file__).resolve().parents[1]


def _toolchain():
    return shutil.which('g++') is not None and any(
        os.path.exists(os.path.join(d, 'jpeglib.h'))
        for d in ('/usr/include', '/usr/local/include',
                  '/usr/include/x86_64-linux-gnu'))


@pytest.fixture
def native():
    if not _toolchain():
        pytest.skip('g++ or jpeglib.h is missing: the native pool cannot '
                    'be built here')
    assert tn.is_available()
    if not jn.is_available():
        pytest.skip("gltvae's native loader is not built")
    return tn


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp('celeba')
    write_celeba_corpus(str(root), 24, 8, 8, seed=4)
    return root


def test_builds_its_own_copy_into_build(native):
    assert tn.LIB_PATH == ROOT / 'build' / 'gltvae_torch' / \
        'libgltvae_torch_loader.so'
    assert tn.LIB_PATH.exists()
    assert tn.LIB_PATH.stat().st_mtime >= tn.SOURCE.stat().st_mtime
    assert tn.SOURCE == ROOT / 'gltvae_torch' / 'native' / 'loader.cpp'
    assert tn._load().gltvae_version() == jn._load().gltvae_version() == 1


def test_the_copy_is_gltvaes_code():
    """Only the header comment differs from native/loader.cpp."""
    def code(p):
        text = p.read_text()
        return text[text.index('#include <atomic>'):]
    assert code(tn.SOURCE) == code(ROOT / 'native' / 'loader.cpp')


@pytest.mark.parametrize('size,crop', [(64, False), (128, True), (72, False)])
@pytest.mark.parametrize('threads', [1, 4])
def test_batches_byte_equal_gltvae(native, corpus, size, crop, threads):
    img = corpus / 'img_align_celeba'
    paths = [str(img / n) for n in sorted(os.listdir(img))]
    got = tn.decode_batch(paths, size, crop, threads)
    want = jn.decode_batch(paths, size, crop, threads)
    assert got.shape == (len(paths), size, size, 3)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize('sup', [0.5, 1.0])
def test_reader_native_loaders_equal_gltvae(native, corpus, sup):
    kw = dict(data_dir=str(corpus), split_file='list_eval_partition.csv',
              decode_backend='native', num_workers=3)
    jl = jc.CelebAReader(jcfg.DataConfig(**kw), sup, 8).setup_data_loaders()
    tl = tc.CelebAReader(tcfg.DataConfig(**kw), sup, 8).setup_data_loaders()
    assert list(tl) == list(jl)
    for m in jl:
        assert isinstance(tl[m].dataset, tn.NativeImageFolderDataset)
        assert tl[m].num_workers == 1
        it, ij = iter(tl[m]), iter(jl[m])
        for _ in range(2 * jl[m].epoch_batches):
            (x, y), (jx, jy) = next(it), next(ij)
            assert np.array_equal(x, jx) and np.array_equal(y, jy)
        it.close()


def test_missing_file_raises(native, tmp_path):
    with pytest.raises(IOError, match='nope.jpg'):
        tn.decode_batch([str(tmp_path / 'nope.jpg')], 64)


def test_rebuilds_when_the_source_is_newer(native, tmp_path, monkeypatch):
    lib = tmp_path / 'lib.so'
    monkeypatch.setattr(tn, 'LIB_PATH', lib)
    tn.build()
    first = lib.stat().st_mtime_ns
    assert tn.build() == lib and lib.stat().st_mtime_ns == first
    old = tn.SOURCE.stat().st_mtime - 10
    os.utime(lib, (old, old))
    tn.build()
    assert lib.stat().st_mtime >= tn.SOURCE.stat().st_mtime


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    if shutil.which('g++') is None:
        pytest.skip('no g++')
    bad = tmp_path / 'bad.cpp'
    bad.write_text('int f( {\n')
    monkeypatch.setattr(tn, 'SOURCE', bad)
    monkeypatch.setattr(tn, 'LIB_PATH', tmp_path / 'lib.so')
    with pytest.raises(RuntimeError, match=r'failed \(exit 1\):\n.*error'):
        tn.build()
    assert not (tmp_path / 'lib.so').exists()
