"""The hand-written Hopper SSD-scan kernel and its ctypes wrapper.

``csrc/ssd_scan.cu`` holds the kernel (its header says which TPU kernel it
replaces, what bounds it and how its working set fits in shared memory).
``kernels._build`` compiles it at first use with ``nvcc`` for ``sm_90a``
into ``build/`` and loads it with ``ctypes``.

``ssd_scan_cuda`` takes CUDA tensors only, checks them, allocates ``y`` and
``h_final`` with ``torch.empty`` and launches on the current stream.  It
masks its own ragged edge (steps past S are inert), so S need not be a
multiple of the chunk.  ``ssd_scan_cuda.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import Library, raise_on

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
MAX_CHUNK = 128
MAX_HEAD_DIM = 128
MAX_SMEM_BYTES = 232448
_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
LIBRARY = Library(SOURCE, {
    # x, dt, A, B, C, h0, y, h_out, bz, s, h, p, n, chunk, is_bf16, stream
    "ssd_scan_fwd": [_P] * 8 + [_I] * 7 + [_P],
})


def smem_bytes(chunk: int, p: int, n: int) -> int:
    """Shared memory one block takes (the formula of ``smem_floats`` in the
    source): B padded by four floats a row, one 32-row tile of C and of the
    decay-weighted products, x, the transposed state and three (Q,) vectors."""
    return 4 * (chunk * (n + 4) + 32 * n + chunk * p + 32 * chunk + n * p
                + 3 * chunk)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def ssd_scan_cuda(x, dt, A, B, C, h0, *, chunk: int):
    """x (Bz,S,H,P) f32/bf16; dt (Bz,S,H) f32; A (H,) f32; B, C (Bz,S,N) in
    x's dtype; h0 (Bz,H,P,N) f32.  Returns (y like x, h_final f32)."""
    _check(x.is_cuda, f"x must be a CUDA tensor, got {x.device}")
    _check(x.dtype in _DTYPES, f"x dtype {x.dtype} not in {_DTYPES}")
    _check(x.dim() == 4, f"x must be (Bz, S, H, P), got {tuple(x.shape)}")
    bz, s, h, p = x.shape
    n = B.shape[-1]
    shapes = {"dt": (bz, s, h), "A": (h,), "B": (bz, s, n), "C": (bz, s, n),
              "h0": (bz, h, p, n)}
    dtypes = {"dt": torch.float32, "A": torch.float32, "B": x.dtype,
              "C": x.dtype, "h0": torch.float32}
    for name, t in {"x": x, "dt": dt, "A": A, "B": B, "C": C, "h0": h0}.items():
        _check(t.device == x.device, f"{name} on {t.device}, x on {x.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        if name != "x":
            _check(tuple(t.shape) == shapes[name],
                   f"{name} must be {shapes[name]}, got {tuple(t.shape)}")
            _check(t.dtype == dtypes[name],
                   f"{name} dtype {t.dtype} != {dtypes[name]}")
    # the kernel reads B, C and its product tiles 16 bytes at a time
    _check(4 <= chunk <= MAX_CHUNK and chunk % 4 == 0,
           f"chunk {chunk} must be a multiple of 4 in [4, {MAX_CHUNK}]")
    _check(n % 8 == 0, f"state size N={n} must be a multiple of 8")
    _check(p <= MAX_HEAD_DIM, f"head dim {p} > {MAX_HEAD_DIM}")
    _check(smem_bytes(chunk, p, n) <= MAX_SMEM_BYTES,
           f"chunk {chunk}, P {p}, N {n} need {smem_bytes(chunk, p, n)} B of "
           f"shared memory > {MAX_SMEM_BYTES}")
    y = torch.empty_like(x)
    h_out = torch.empty((bz, h, p, n), dtype=torch.float32, device=x.device)
    err = LIBRARY.get().ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h_out.data_ptr(), bz, s, h, p, n, chunk,
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(err, "ssd_scan_fwd")
    ssd_scan_cuda.launches += 1
    return y, h_out


ssd_scan_cuda.launches = 0
