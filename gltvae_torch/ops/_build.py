"""Build and load the port's CUDA kernels (nvcc into a shared library with a
plain C interface, loaded with ctypes).

Each ``csrc/<name>.cu`` becomes ``build/gltvae_torch/lib<name>-<hash>.so``
at the repository root, where ``<hash>`` covers the source, the shared
headers (``csrc/*.cuh``) and the compiler flags, so a stale library is
never loaded. Nothing is built at import: a library is compiled at its
first use, or by ``build_all``, which starts one nvcc per source at once.
ptxas's register/spill report for each build is kept beside it as
``lib<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'gltvae_torch'

# Never add --use_fast_math or -prec-div=false: the dequant kernel's divide
# form must round exactly like torch's f32 division, and every kernel's
# multiply like torch's.
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

KERNEL_SOURCES = ('dequant', 'augment')

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    # torch looks in $CUDA_HOME / $CUDA_PATH, then beside the nvcc on PATH,
    # then in /usr/local/cuda
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME or '', 'bin', 'nvcc')
    if not CUDA_HOME or not os.path.exists(nvcc):
        raise RuntimeError('nvcc not found: set CUDA_HOME to the CUDA toolkit')
    return nvcc


def library_path(name: str) -> Path:
    src = (CSRC / f'{name}.cu').read_bytes()
    headers = b''.join(p.read_bytes() for p in sorted(CSRC.glob('*.cuh')))
    digest = hashlib.sha256(src + headers
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'lib{name}-{digest[:16]}.so'


def _start(name: str) -> Optional[tuple]:
    """Start nvcc for csrc/<name>.cu unless its library is built already;
    returns (process, temporary output, final output)."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    log = open(out.with_suffix('.log'), 'w')
    try:
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')],
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    return proc, tmp, out


def _finish(name: str, started: Optional[tuple]) -> None:
    if started is None:
        return
    proc, tmp, out = started
    rc = proc.wait()
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed on csrc/{name}.cu (exit {rc}):\n'
                           + out.with_suffix('.log').read_text())
    os.replace(tmp, out)


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> float:
    """Build every kernel library at once (one nvcc each, in parallel);
    returns the seconds it took."""
    t0 = time.perf_counter()
    with _lock:
        procs = {n: _start(n) for n in names}
        for n, p in procs.items():
            _finish(n, p)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    path = library_path(name).with_suffix('.log')
    return path.read_text() if path.exists() else ''


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                _libs[name] = lib
    return lib
