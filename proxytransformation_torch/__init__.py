"""PyTorch/CUDA port of the ProxyTransformation grounder.

The package mirrors `proxytransformation_tpu` module for module
(`ops/`, `models/`, `structures/`) and uses the upstream state_dict key
names, so a reference checkpoint loads with `load_state_dict`. It never
imports JAX. Every op that the JAX package wrote as a Pallas TPU kernel
is a hand-written CUDA kernel for Hopper (`csrc/`), built with nvcc at
first use; every other op is plain PyTorch.

Dispatch rule for each kernel wrapper: a CPU tensor takes the plain
PyTorch version, a CUDA tensor launches the kernel or raises.
"""
from .device import resolve_device

__all__ = ['resolve_device']
