"""The hand-written Hopper MoE dispatch-rank kernel and its ctypes wrapper.

``csrc/moe_dispatch.cu`` holds the kernel (its header says which TPU kernel
it replaces, what bounds it and how the serial tile carry became a prefix
across tiles).  ``kernels._build`` compiles it at first use with ``nvcc``
for ``sm_90a`` into ``build/`` and loads it with ``ctypes``.

``moe_positions_cuda`` takes CUDA tensors only, checks them, allocates
``pos``, ``counts`` and the per-tile scratch with ``torch.empty`` and
launches on the current stream.  ``moe_positions_cuda.launches`` counts its
calls (one call is up to three launches of the kernel's passes).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import Library, raise_on

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_dispatch.cu"
TILE = 256            # assignments per block (kTile in the source)
MAX_EXPERTS = 1024    # the per-warp counts of a tile live in shared memory

_P = ctypes.c_void_p
_I = ctypes.c_int
LIBRARY = Library(SOURCE, {
    # ids, pos, counts, scratch, n, e, stream
    "moe_positions": [_P] * 4 + [_I] * 2 + [_P],
})


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def moe_positions_cuda(expert_ids: torch.Tensor, n_experts: int):
    """expert_ids (T, K) int32 on the card -> pos (T, K) int32, counts (E,)
    int32.  Ids outside [0, E) get position 0 and count nowhere."""
    _check(expert_ids.is_cuda, f"expert_ids must be a CUDA tensor, got "
           f"{expert_ids.device}")
    _check(expert_ids.dtype == torch.int32,
           f"expert_ids must be int32, got {expert_ids.dtype}")
    _check(expert_ids.dim() == 2, f"expert_ids must be (T, K), got "
           f"{tuple(expert_ids.shape)}")
    _check(expert_ids.is_contiguous(), "expert_ids must be contiguous")
    _check(1 <= n_experts <= MAX_EXPERTS,
           f"n_experts={n_experts} not in [1, {MAX_EXPERTS}]")
    n = expert_ids.numel()
    _check(n < 2 ** 31, f"{n} assignments exceed an int32 index")
    dev = expert_ids.device
    pos = torch.empty_like(expert_ids)
    counts = torch.empty((n_experts,), dtype=torch.int32, device=dev)
    n_tiles = -(-n // TILE)
    scratch = torch.empty((max(n_tiles, 1), n_experts), dtype=torch.int32,
                          device=dev)
    err = LIBRARY.get().moe_positions(
        expert_ids.data_ptr(), pos.data_ptr(), counts.data_ptr(),
        scratch.data_ptr(), n, n_experts,
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "moe_positions")
    moe_positions_cuda.launches += 1
    return pos, counts


moe_positions_cuda.launches = 0
