"""Build and load the hand-written CUDA kernels in `csrc/`.

Each `csrc/<name>.cu` compiles with nvcc for `sm_90a` into its own
shared library with a plain C interface,
`build/torch_kernels/lib<name>-<key>.so` beside the package, and is loaded
with ctypes. The key hashes the nvcc flags and the text of the source and
of every `csrc/*.cuh`, so a change to either builds a new library. Nothing
is compiled or loaded when a module is imported: the first launch builds
what is missing, or `build()` does it up front, one nvcc per source, all
started together.

Every C entry point takes device pointers and PyTorch's current stream,
launches on that stream, does not synchronise, and returns
`cudaGetLastError()`; `CudaKernel.__call__` raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from functools import lru_cache
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR.parent / 'build' / 'torch_kernels'
SOURCES = ('ball_query', 'lookup_pmz', 'sparse_conv', 'sparse_conv_dw',
           'sparse_conv_bf16', 'row_gather')
# ball query compares against r² at the boundary: no FMA contraction, so
# d² rounds exactly like the reference's separate multiplies and adds
_EXTRA_FLAGS = {'ball_query': ['-fmad=false']}

ptr = ctypes.c_void_p
i32 = ctypes.c_int
f32 = ctypes.c_float

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
KERNELS: Dict[str, 'CudaKernel'] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get('CUDA_HOME') or '/usr/local/cuda') / 'bin/nvcc'
    if cand.exists():
        return str(cand)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')
    return found


def _flags(name: str) -> List[str]:
    return ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
            '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
            *_EXTRA_FLAGS.get(name, [])]


def _lib_path(name: str) -> Path:
    key = hashlib.sha256(' '.join(_flags(name)).encode())
    for src in [CSRC_DIR / f'{name}.cu', *sorted(CSRC_DIR.glob('*.cuh'))]:
        key.update(src.read_bytes())
    return BUILD_DIR / f'lib{name}-{key.hexdigest()[:16]}.so'


def build(names: Iterable[str] = SOURCES) -> List[str]:
    """Compile the missing kernel libraries in parallel; return nvcc's
    output per source (registers, shared memory and spills from
    `-Xptxas -v`). Raises with the compiler's output on failure."""
    with _lock:
        todo = [n for n in names if not _lib_path(n).exists()]
        if not todo:
            return []
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name in todo:
            tmp = BUILD_DIR / f'lib{name}.{os.getpid()}.tmp'
            cmd = [nvcc, *_flags(name), '-o', str(tmp),
                   str(CSRC_DIR / f'{name}.cu')]
            procs.append((name, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, errors = [], []
        for name, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                errors.append(f'{name}.cu: nvcc exit {proc.returncode}\n{out}')
            else:
                os.replace(tmp, _lib_path(name))
                _lib_path(name).with_suffix('.log').write_text(out)
                logs.append(f'{name}.cu\n{out}')
        if errors:
            raise RuntimeError('kernel build failed:\n' + '\n'.join(errors))
        return logs


def build_log(name: str) -> str:
    """nvcc's output (`-Xptxas -v`) from the build of library `name`'s
    current source and flags."""
    return _lib_path(name).with_suffix('.log').read_text()


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(_lib_path(name))))
    return lib


@lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def current_stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               shape: Sequence[int]) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype`/`shape`."""
    if not t.is_cuda:
        raise ValueError(f'{name}: expected a CUDA tensor, got {t.device}')
    if t.dtype != dtype:
        raise ValueError(f'{name}: expected {dtype}, got {t.dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, '
                         f'got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')


class CudaKernel:
    """One C entry point of a kernel library, with a launch counter.

    `launches` goes up by one for each successful call of the entry
    point, so a run can show that the main path went through the kernel;
    the entry point launches `kernels_per_call` device kernels.
    """

    def __init__(self, name: str, library: str, symbol: str,
                 argtypes: Sequence, source: str, replaces: str,
                 kernels_per_call: int = 1):
        self.name = name
        self.library = library
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.source = source
        self.replaces = replaces
        self.kernels_per_call = kernels_per_call
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = _library(self.library)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.ptt_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._err = err
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f'{self.symbol}: CUDA error {rc} '
                               f'({self._err(rc).decode()})')
        self.launches += 1


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
