"""The hand-written Hopper SSD-scan kernel and its ctypes wrapper.

``csrc/ssd_scan.cu`` holds the kernel (its header says which TPU kernel it
replaces, what bounds it and what each body's design does about it).
``kernels._build`` compiles it at first use with ``nvcc`` for ``sm_90a``
into ``build/`` and loads it with ``ctypes``.

The kernel has two bodies, chosen per call by ``plan_ssd`` (plain Python,
so the CPU tests see the route):

- ``tensor_core``: bf16 with the chunk, P and N multiples of 16, N at most
  128, when its shared memory fits (both serving shapes).  One block per
  slice of up to ``SLICE`` head dims of one (lane, head), walking the
  chunks in order; products on ``mma.sync`` with every f32 operand as
  hi + lo bf16 halves.
- ``cuda_core``: f32 (the tensor cores would round it to TF32) and bf16
  shapes off that grid: one block per (lane, head), f32 products on the
  CUDA cores.

``ssd_scan_cuda`` takes CUDA tensors only, checks them, allocates ``y`` and
``h_final`` with ``torch.empty`` and launches on the current stream; a
launch that fails raises.  It masks its own ragged edge (steps past S are
inert), so S need not be a multiple of the chunk.  ``ssd_scan_cuda.launches``
counts its launches and ``ssd_scan_cuda.body_launches`` the launches per
body.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels._build import Library, raise_on

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
MAX_CHUNK = 128
MAX_HEAD_DIM = 128
MAX_TC_STATE = 128     # most state columns the tensor-core fragments hold
MAX_SMEM_BYTES = 232448
_DTYPES = (torch.float32, torch.bfloat16)

# The bodies; the wrapper picks one by ``plan_ssd``.
TENSOR_CORE, CUDA_CORE = "tensor_core", "cuda_core"
BODIES = (TENSOR_CORE, CUDA_CORE)
SLICES = (16, 32, 64)  # head-dim slice widths the tensor-core body is built for
SLICE = 64             # the widest that divides P is taken (chip_smoke.py sweeps)

_P = ctypes.c_void_p
_I = ctypes.c_int
LIBRARY = Library(SOURCE, {
    # x, dt, A, B, C, h0, y, h_out, bz, s, h, p, n, chunk, is_bf16, stream
    "ssd_scan_fwd": [_P] * 8 + [_I] * 7 + [_P],
    # x, dt, A, B, C, h0, y, h_out, bz, s, h, p, n, chunk, slice, stream
    "ssd_scan_fwd_tc": [_P] * 8 + [_I] * 7 + [_P],
})


def smem_bytes(chunk: int, p: int, n: int, body: str = CUDA_CORE) -> int:
    """Shared memory one block takes (the formulas of the source's header).

    ``cuda_core`` (``smem_floats``): B padded by four floats a row, one
    32-row tile of C and of the decay-weighted products, x, the transposed
    state and three (Q,) vectors.  ``tensor_core`` (``tc_smem_bytes``), with
    ``p`` the slice width: two ring stages of bf16 B and x rows padded by 16
    bytes and f32 dt; one stage of C rows (each warp's next rows land once
    its fragments of the current ones are in registers); two buffers of the
    chunk's scan (16 bytes a step); the state's hi and lo bf16 halves."""
    if body == TENSOR_CORE:
        ldn, ldx = n + 8, p + 8
        return (2 * (chunk * ldn * 2 + chunk * ldx * 2 + 4 * chunk)
                + chunk * ldn * 2 + 2 * 16 * chunk + 2 * p * ldn * 2)
    return 4 * (chunk * (n + 4) + 32 * n + chunk * p + 32 * chunk + n * p
                + 3 * chunk)


class Plan(NamedTuple):
    """How the kernel runs one call.  ``body``: one of ``BODIES``;
    ``slice``: head dims per block; ``grid``: blocks as launched (x, y, z);
    ``smem``: shared-memory bytes per block."""
    body: str
    slice: int
    grid: tuple
    smem: int


def plan_ssd(dtype, bz: int, s: int, h: int, p: int, n: int,
             chunk: int) -> Plan:
    """The kernel's plan for x (bz, s, h, p) and B, C (bz, s, n) in
    ``dtype`` at ``chunk``.

    bf16 with the chunk, P and N multiples of 16, N <= ``MAX_TC_STATE`` and
    the body's shared memory within ``MAX_SMEM_BYTES`` takes the tensor-core
    body over slices of the widest of ``SLICES`` up to ``SLICE`` that
    divides P, grid (P / slice, H, Bz).  Everything else takes the CUDA-core
    body, grid (H, Bz): a chunk that is a multiple of 4 up to 128, N a
    multiple of 8, P <= 128 and its shared memory within the limit, or the
    call is refused."""
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype} not in {_DTYPES}")
    if (dtype == torch.bfloat16 and 16 <= chunk <= MAX_CHUNK
            and chunk % 16 == 0 and p % 16 == 0 and n % 16 == 0
            and n <= MAX_TC_STATE):
        pb = max(w for w in SLICES if w <= SLICE and p % w == 0)
        smem = smem_bytes(chunk, pb, n, TENSOR_CORE)
        if smem <= MAX_SMEM_BYTES:
            return Plan(TENSOR_CORE, pb, (p // pb, h, bz), smem)
    # the CUDA-core body reads B, C and its product tiles 16 bytes at a time
    _check(4 <= chunk <= MAX_CHUNK and chunk % 4 == 0,
           f"chunk {chunk} must be a multiple of 4 in [4, {MAX_CHUNK}]")
    _check(n % 8 == 0, f"state size N={n} must be a multiple of 8")
    _check(p <= MAX_HEAD_DIM, f"head dim {p} > {MAX_HEAD_DIM}")
    smem = smem_bytes(chunk, p, n)
    _check(smem <= MAX_SMEM_BYTES, f"chunk {chunk}, P {p}, N {n} need {smem} "
           f"B of shared memory > {MAX_SMEM_BYTES}")
    return Plan(CUDA_CORE, p, (h, bz, 1), smem)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def ssd_scan_cuda(x, dt, A, B, C, h0, *, chunk: int):
    """x (Bz,S,H,P) f32/bf16; dt (Bz,S,H) f32; A (H,) f32; B, C (Bz,S,N) in
    x's dtype; h0 (Bz,H,P,N) f32.  Returns (y like x, h_final f32).  The
    body is ``plan_ssd``'s; each call adds one to ``launches`` and to its
    body's count in ``body_launches``."""
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
    plan = plan_ssd(x.dtype, bz, s, h, p, n, chunk)
    if plan.body == TENSOR_CORE:
        # 16-byte copies of the x, B and C rows, 8-byte reads of h0
        for name, t in {"x": x, "B": B, "C": C, "h0": h0}.items():
            _check(t.data_ptr() % 16 == 0,
                   f"{name} must start on a 16-byte boundary")
    y = torch.empty_like(x)
    h_out = torch.empty((bz, h, p, n), dtype=torch.float32, device=x.device)
    lib = LIBRARY.get()
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), h0.data_ptr(), y.data_ptr(), h_out.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan.body == TENSOR_CORE:
        err = lib.ssd_scan_fwd_tc(*ptrs, bz, s, h, p, n, chunk, plan.slice,
                                  stream)
        raise_on(err, "ssd_scan_fwd_tc")
    else:
        err = lib.ssd_scan_fwd(*ptrs, bz, s, h, p, n, chunk,
                               int(x.dtype == torch.bfloat16), stream)
        raise_on(err, "ssd_scan_fwd")
    ssd_scan_cuda.launches += 1
    ssd_scan_cuda.body_launches[plan.body] += 1
    return y, h_out


def reset_ssd_counts():
    """Set the kernel's launch counts, total and per body, to 0."""
    ssd_scan_cuda.launches = 0
    ssd_scan_cuda.body_launches = dict.fromkeys(BODIES, 0)


reset_ssd_counts()
