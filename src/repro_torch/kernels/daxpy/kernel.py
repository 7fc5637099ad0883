"""The hand-written Hopper daxpy kernel and its ctypes wrapper.

``csrc/daxpy.cu`` holds the kernel (its header says which TPU kernel it
replaces, what bounds it and how it rounds as the plain version does).
``kernels._build`` compiles it at first use with ``nvcc`` for ``sm_90a`` into
``build/`` and loads it with ``ctypes``.

``daxpy_cuda`` takes CUDA tensors only, checks them, allocates the output
with ``torch.empty`` and launches on the current stream.
``daxpy_cuda.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import Library, raise_on

SOURCE = Path(__file__).resolve().parent / "csrc" / "daxpy.cu"
_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
LIBRARY = Library(SOURCE, {
    # x, y, out, a, n, len, block, is_bf16, stream
    "daxpy": [_P] * 3 + [ctypes.c_float, ctypes.c_longlong, ctypes.c_longlong,
                         ctypes.c_int, ctypes.c_int, _P],
})


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def check_block(block: int):
    _check(block >= 8 and block % 8 == 0,
           f"block {block} must be a positive multiple of 8")


def daxpy_cuda(x: torch.Tensor, y: torch.Tensor, a: float, n: int, *,
               block: int) -> torch.Tensor:
    """x, y (len,) f32 or bf16 on the card; ``a`` already rounded to their
    dtype.  Returns out (len,): a*x + y for i < n, y past n."""
    _check(x.is_cuda, f"x must be a CUDA tensor, got {x.device}")
    _check(x.dtype in _DTYPES, f"x dtype {x.dtype} not in {_DTYPES}")
    _check(x.dim() == 1, f"x must be (len,), got {tuple(x.shape)}")
    _check(y.device == x.device and y.dtype == x.dtype
           and y.shape == x.shape, f"y {tuple(y.shape)} {y.dtype} on "
           f"{y.device} does not match x")
    _check(x.is_contiguous() and y.is_contiguous(), "x and y must be contiguous")
    check_block(block)
    out = torch.empty_like(x)
    err = LIBRARY.get().daxpy(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), float(a), int(n),
        x.shape[0], block, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(err, "daxpy")
    daxpy_cuda.launches += 1
    return out


daxpy_cuda.launches = 0
