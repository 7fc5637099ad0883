"""The hand-written Hopper ``fadda`` kernel and its ctypes wrapper.

``csrc/fadda.cu`` holds the kernel (its header says which TPU kernel it
replaces, why a dependency chain and not bytes bounds it, and how the loads
and stores are kept off that chain).  ``kernels._build`` compiles it at
first use with ``nvcc`` for ``sm_90a`` into ``build/`` and loads it with
``ctypes``.

``plan_fadda`` sizes the kernel's shared-memory rings; ``fadda_rows_cuda``
takes CUDA tensors only, checks them, allocates the outputs with
``torch.empty`` and launches on the current stream.
``fadda_rows_cuda.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import Library, raise_on

SOURCE = Path(__file__).resolve().parent / "csrc" / "fadda.cu"
MAX_BLOCK = 8192      # 4 + 2 tiles and 16 KB of checkpoints: 208 KB at 8192 floats
RING_BYTES = 64 * 1024  # input tiles staged ahead of the walker, at most
MIN_STAGES, MAX_STAGES = 4, 8
AHEAD = 7             # groups of 8 the walker reads or writes past the last it added
SMEM_CAP = 232448     # 227 KB: the shared memory one block may use on an H100

_P = ctypes.c_void_p
_I = ctypes.c_int
LIBRARY = Library(SOURCE, {
    # x, ld, n, init, partials (or null), out, rows, v, block, stages,
    # ctiles, stream
    "fadda_rows": [_P, ctypes.c_longlong] + [_P] * 4 + [_I] * 5 + [_P],
})


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def check_block(block: int):
    _check(8 <= block <= MAX_BLOCK and block % 8 == 0,
           f"block {block} must be a multiple of 8 in [8, {MAX_BLOCK}]")


def plan_fadda(block: int, partials: bool) -> dict:
    """The kernel's shared memory at tile width ``block``: ``stages`` input
    tiles (as many as fit in ``RING_BYTES``, 4 to 8); with partials also two
    partial tiles and ``ctiles`` tiles of checkpoints (one float per group
    of 8: 4 tiles, or 8 below 56 floats); two mbarriers per input and
    checkpoint tile; ``smem_bytes`` in all (``smem_bytes`` in the source
    computes the same).  Either ring holds more than ``AHEAD`` groups beyond
    the tile in use, else the walker would wait for a tile that cannot be
    refilled before it frees one."""
    check_block(block)
    tile = 4 * block
    stages = min(MAX_STAGES, max(MIN_STAGES, RING_BYTES // tile))
    ctiles = (4 if block >= 8 * AHEAD else 8) if partials else 0
    checkpoints = -(-ctiles * (block // 8) // 4) * 4
    smem = (tile * (stages + (2 if partials else 0)) + 4 * checkpoints
            + 16 * (stages + ctiles))
    return dict(stages=stages, ctiles=ctiles, smem_bytes=smem)


def fadda_rows_cuda(x: torch.Tensor, n: torch.Tensor, init: torch.Tensor, *,
                    partials: bool, block: int):
    """x (rows, V) f32 on the card, contiguous; n (rows,) int32; init
    (rows,) f32.  Returns (out (rows,), partials (rows, V) or None): the
    strictly ordered sums of each row, elements at or past ``n`` adding +0.0,
    and with ``partials`` every inclusive prefix."""
    _check(x.is_cuda, f"x must be a CUDA tensor, got {x.device}")
    _check(x.dtype == torch.float32, f"x must be float32, got {x.dtype}")
    _check(x.dim() == 2 and x.shape[0] >= 1,
           f"x must be (rows >= 1, V), got {tuple(x.shape)}")
    _check(x.is_contiguous(), "x must be contiguous")
    rows, v = x.shape
    _check(v < 2 ** 31, f"rows of {v} elements exceed an int32 index")
    for name, t, dtype in (("n", n, torch.int32), ("init", init, torch.float32)):
        _check(t.device == x.device, f"{name} on {t.device}, x on {x.device}")
        _check(t.dtype == dtype and tuple(t.shape) == (rows,)
               and t.is_contiguous(),
               f"{name} must be contiguous ({rows},) {dtype}, got "
               f"{tuple(t.shape)} {t.dtype}")
    plan = plan_fadda(block, partials)
    out = torch.empty((rows,), dtype=torch.float32, device=x.device)
    part = (torch.empty((rows, v), dtype=torch.float32, device=x.device)
            if partials else None)
    err = LIBRARY.get().fadda_rows(
        x.data_ptr(), v, n.data_ptr(), init.data_ptr(),
        None if part is None else part.data_ptr(), out.data_ptr(), rows, v,
        block, plan["stages"], plan["ctiles"],
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(err, "fadda_rows")
    fadda_rows_cuda.launches += 1
    return out, part


fadda_rows_cuda.launches = 0
