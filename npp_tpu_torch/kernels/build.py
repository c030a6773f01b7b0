"""Build the port's CUDA C++ kernels at first use and bind them with ctypes.

Each `csrc/<name>.cu` exports plain C functions and is compiled by `nvcc`
into `npp_tpu_torch/build/lib<name>-<hash>.so`, keyed by the source's hash so
an edited source rebuilds. No PyTorch headers are included, which keeps a
build to seconds. Triton's cache is pointed into the same build directory so
nothing is written outside the checkout. A host library (`csrc/<name>.cpp`,
the segmentation's graph cut) is compiled the same way by `g++`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(PKG_DIR, 'build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC']
# no fused multiply-adds: the inpainting repeats OpenCV's float rounding
GXX_CMD = ['g++', '-O2', '-shared', '-fPIC', '-std=c++17',
           '-ffp-contract=off']

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if cand and os.path.exists(os.path.join(cand, 'bin', 'nvcc')):
            return os.path.join(cand, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels are built from '
                           'csrc/ at first use and need the CUDA toolkit')
    return found


def build_library(name: str, ptxas_verbose: bool = False) -> str:
    """Compile csrc/<name>.cu unless an up-to-date build exists. Returns
    the library path. With ptxas_verbose, compiles even when cached and
    prints nvcc's `-Xptxas -v` report (registers, shared memory, spills)."""
    return _build(f'{name}.cu', [nvcc_path(), *NVCC_FLAGS],
                  ['-Xptxas', '-v'] if ptxas_verbose else [], ptxas_verbose)


def build_host_library(name: str) -> str:
    """Compile the host library csrc/<name>.cpp with g++ unless an
    up-to-date build exists; returns its path."""
    return _build(f'{name}.cpp', GXX_CMD, [], False)


def _build(src_name: str, cmd0, extra, force: bool) -> str:
    src = os.path.join(CSRC_DIR, src_name)
    name = os.path.splitext(src_name)[0]
    with open(src, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(cmd0).encode()
                                ).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f'lib{name}-{digest}.so')
    if os.path.exists(out) and not force:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.tmp{os.getpid()}'
    cmd = [*cmd0, *extra, '-o', tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'{cmd0[0]} failed for {src}:\n{proc.stdout}\n'
                           f'{proc.stderr}')
    if extra:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, out)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu once per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_library(name))
            _LIBS[name] = lib
        return lib


def triton_setup():
    """Import Triton, with its cache inside the build directory; returns
    (triton, triton.language, libdevice). Called by the Triton wrappers at
    their first launch, never at import."""
    os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(BUILD_DIR, 'triton'))
    import triton
    import triton.language as tl
    try:
        from triton.language.extra import libdevice        # Triton >= 3.2
    except ImportError:
        from triton.language.extra.cuda import libdevice   # Triton 3.0, 3.1
    return triton, tl, libdevice


def check_cuda(status: int, what: str) -> None:
    """Raise if a C launcher returned a non-zero cudaGetLastError()."""
    if status != 0:
        raise RuntimeError(f'{what}: CUDA launch failed with error {status}')
