"""Device selection for the port's entry points."""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    `None` means the card: it raises when CUDA is absent rather than
    carrying on quietly on the CPU. Pass `device='cpu'` to run the plain
    PyTorch versions of the kernels on the CPU.
    """
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available; pass device="cpu" to run the plain '
            'PyTorch path on the CPU')
    return dev


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """Full float32 matmuls and convolutions inside the block (cuDNN
    allows TF32 by default, which keeps about three decimal digits), and
    float32 sums in bfloat16 matmuls (cuBLAS may otherwise reduce split
    products in bfloat16); the caller's settings come back on exit."""
    matmul = torch.backends.cuda.matmul
    saved = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             matmul.allow_bf16_reduced_precision_reduction)
    matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = saved
