"""Cache locations (the JAX package's utils/cache.py).

`machine_keyed_cache_dir` is re-housed as it is, keyed by the torch
version where the JAX package keys by jax's. The JAX module's three other
functions configure XLA's persistent compilation cache
(`enable_compilation_cache`, `enable_cpu_compilation_cache` and the
serialization guard behind it); PyTorch compiles nothing of the port's
that way. Their counterpart here is the kernel build of `ops/_cuda.py`:
each `csrc/*.cu` library is built once by nvcc into
`build/torch_kernels/lib<name>-<key>.so` beside the package, the key a
hash of the flags and the source, so a rerun reuses it and a change to
either builds anew (the host image decoder likewise under
`build/torch_host/`, `data/image_io.py`).
"""
import hashlib
import os
import platform

import torch


def machine_keyed_cache_dir(prefix: str = 'pt_torch_cpu') -> str:
    """`~/.cache/<prefix>_v2_<arch>_<cpu flags hash>_<torch version>`.

    A cache of compiled CPU code embeds the compiling machine's CPU
    features, and replaying it on another CPU can die with SIGILL; keying
    the directory by a hash of /proc/cpuinfo's flags (with the arch and
    the torch version) makes a moved disk image start a fresh cache. The
    path is returned, not created."""
    try:
        with open('/proc/cpuinfo') as f:
            flags_line = next((ln for ln in f if ln.startswith('flags')), '')
        tag = hashlib.sha1(flags_line.encode()).hexdigest()[:8]
    except OSError:
        tag = 'nocpuinfo'
    return os.path.expanduser(
        f'~/.cache/{prefix}_v2_{platform.machine()}_{tag}_'
        f'{torch.__version__}')
