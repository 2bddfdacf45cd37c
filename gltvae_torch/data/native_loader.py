"""ctypes binding for the port's C++ decode pool (gltvae_torch/native/
loader.cpp; counterpart of gltvae/data/native_loader.py, same C ABI).

A decode backend for CelebAReader: a whole batch of JPEGs decoded in
parallel with libjpeg outside the GIL, bilinear-resized, written as uint8
RGB into a numpy buffer.

The library is built from source on first use, with ``g++ -O3 -fPIC
-std=c++17 -shared ... -ljpeg -lpthread``, into ``build/gltvae_torch/`` at
the repository root, and rebuilt when loader.cpp is newer. Unlike the JAX
package, which falls back when its build fails, a failed build raises with
the compiler's output: asking for the native backend never silently gets
another. ``is_available()`` says whether it builds here (for the tests'
skips).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / 'native' / 'loader.cpp'
LIB_PATH = (Path(__file__).resolve().parents[2] / 'build' / 'gltvae_torch'
            / 'libgltvae_torch_loader.so')
CXX_FLAGS = ('-O3', '-fPIC', '-std=c++17', '-shared')
LD_FLAGS = ('-ljpeg', '-lpthread')

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build() -> Path:
    """Compile loader.cpp into LIB_PATH unless it is there and newer than
    the source; raises RuntimeError with the compiler's output on failure."""
    if LIB_PATH.exists() and \
            LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIB_PATH
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f'.{os.getpid()}.tmp')
    cmd = ['g++', *CXX_FLAGS, str(SOURCE), '-o', str(tmp), *LD_FLAGS]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f'native loader: cannot run g++: {e}') from None
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'native loader: {" ".join(cmd)} failed '
                           f'(exit {r.returncode}):\n{r.stderr}')
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _load() -> ctypes.CDLL:
    """The loaded library, built on first use; raises RuntimeError when it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except OSError as e:
            raise RuntimeError(f'native loader: cannot load {LIB_PATH}: '
                               f'{e}') from None
        lib.gltvae_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.gltvae_decode_batch.restype = ctypes.c_int
        lib.gltvae_version.restype = ctypes.c_int
        _lib = lib
        return lib


def is_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def decode_batch(paths: Sequence[str], out_size: int,
                 center_crop: bool = False,
                 num_threads: int = 0) -> np.ndarray:
    """Decode + resize a batch of JPEG paths -> (N, S, S, 3) uint8."""
    lib = _load()
    n = len(paths)
    out = np.empty((n, out_size, out_size, 3), dtype=np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    rc = lib.gltvae_decode_batch(
        arr, n, out_size, int(center_crop),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_threads)
    if rc != 0:
        raise IOError(f'JPEG decode failed for {paths[-rc - 1]!r}')
    return out


class NativeImageFolderDataset:
    """ImageFolderDataset's interface over the C++ pool (always resizes on
    the host)."""

    def __init__(self, image_dir: str, split, image_size: int,
                 center_crop: bool = False, num_threads: int = 0):
        _load()
        self.image_dir = image_dir
        self.split = split
        self.image_size = image_size
        self.center_crop = center_crop
        self.num_threads = num_threads

    def __len__(self):
        return len(self.split)

    def fetch(self, idxs: np.ndarray):
        paths = [os.path.join(self.image_dir, self.split.ids[i])
                 for i in idxs]
        imgs = decode_batch(paths, self.image_size, self.center_crop,
                            self.num_threads)
        return imgs, self.split.labels[idxs].astype(np.float32)
