"""The hand-written Hopper MoE dispatch-rank kernel and its ctypes wrapper.

``csrc/moe_dispatch.cu`` holds the kernel (its header says which TPU kernel
it replaces, what bounds it and how the serial tile carry became counts
that the blocks of a thread block cluster share).  ``kernels._build`` compiles it
at first use with ``nvcc`` for ``sm_90a`` into ``build/`` and loads it with
``ctypes``.

``plan_positions`` sizes the launch; ``moe_positions_cuda`` takes CUDA
tensors only, checks them, allocates ``pos`` and ``counts`` as views of one
``torch.empty`` and launches on the current stream: one call is one launch
of one kernel, at every size.  ``moe_positions_cuda.launches`` counts them.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import Library, raise_on

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_dispatch.cu"
WARP = 32
DECODE_ROUNDS = 4     # one warp alone ranks up to 4 rounds: 128 assignments
WARPS = 16            # warps of a block past that
MIN_ROUNDS = 1        # rounds of 32 a warp ranks, at least, past decode
MAX_ROUNDS = 4        # the most (kMaxRounds in the source)
CLUSTER = 8           # blocks of a thread block cluster (kCluster in the source)
MAX_EXPERTS = 1024    # the per-warp counts of a tile live in shared memory
SMEM_CAP = 232448     # 227 KB: the shared memory one block may use on an H100

_P = ctypes.c_void_p
_I = ctypes.c_int
LIBRARY = Library(SOURCE, {
    # ids, pos, counts, n, e, warps, rounds, grid, stream
    "moe_positions": [_P] * 3 + [_I] * 5 + [_P],
})


@functools.lru_cache(maxsize=1024)
def plan_positions(n: int, e: int, sm_count: int) -> dict:
    """The launch for n assignments over e experts on a card of
    ``sm_count`` SMs.  Up to 128 assignments: one block of one warp that
    ranks them in rounds of 32 and meets no block barrier.  Past that,
    blocks of ``WARPS`` warps, each warp ranking ``rounds`` rounds of 32
    (``MIN_ROUNDS`` at least, more where the tiles would not fit in one wave
    of ``sm_count`` blocks, ``MAX_ROUNDS`` at most), in clusters of
    ``CLUSTER`` blocks.  Returns warps, rounds, tile, grid and the shared
    memory in bytes: (warps + 3 + 2 x CLUSTER) x e ints past decode, warps x
    e at it."""
    if n <= WARP * DECODE_ROUNDS:
        r = max(1, -(-n // WARP))
        return dict(warps=1, rounds=r, tile=WARP * r, grid=1, smem_bytes=4 * e)
    per = WARP * WARPS
    r = min(MAX_ROUNDS, max(MIN_ROUNDS, -(-n // (sm_count * per))))
    tile = r * per
    tiles = -(-n // tile)
    return dict(warps=WARPS, rounds=r, tile=tile,
                grid=-(-tiles // CLUSTER) * CLUSTER,
                smem_bytes=4 * (WARPS + 3 + 2 * CLUSTER) * e)


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
    plan = plan_positions(n, n_experts, _sm_count(dev))
    out = torch.empty((n + n_experts,), dtype=torch.int32, device=dev)
    err = LIBRARY.get().moe_positions(
        expert_ids.data_ptr(), out.data_ptr(), out.data_ptr() + 4 * n, n,
        n_experts, plan["warps"], plan["rounds"], plan["grid"],
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "moe_positions")
    moe_positions_cuda.launches += 1
    t, k = expert_ids.shape
    return (out.as_strided((t, k), (k, 1)),
            out.as_strided((n_experts,), (1,), n))


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


moe_positions_cuda.launches = 0
