"""The hand-written Hopper flash-attention kernels and their ctypes wrappers.

``csrc/flash_attention.cu`` holds the kernels (its header says which TPU
kernel each replaces, what bounds it and what the design does about it).
``kernels._build`` compiles it at first use with ``nvcc`` for ``sm_90a``
into ``build/`` at the repo root, named by the hash of the source so an
edited source rebuilds, and loads it with ``ctypes``.

The dense kernel has three bodies, chosen per call by ``plan_dense`` (plain
Python, so the CPU tests see the route):

- ``tensor_core``, bf16 prefill (more than 16 rows per KV head): 64 query
  rows per CTA, Q in registers, bf16 K/V tiles through a cp.async ring,
  ``mma.sync`` products with f32 accumulators.  Bound by operations.
- ``split_kv``, bf16 decode (at most 16 rows per KV head): the live keys of
  each (KV head, lane) split over several CTAs so the card is full, f32
  partials in scratch that this wrapper allocates, merged in split order by
  a second launch.  Bound by bytes.
- ``cuda_core``, f32: the first design, f32 products on the CUDA cores
  (tensor cores would round f32 to TF32).

The paged kernels (full-precision and int8/fp8 pools) keep the CUDA-core
design.

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, raise on anything the kernel does not take, allocate the output
with ``torch.empty`` and launch on the current stream.  Each keeps a plain
integer launch count (``flash_dense_cuda.launches``,
``flash_paged_cuda.launches``, ``flash_paged_quant_cuda.launches``) that
grows by one per call; ``flash_dense_cuda.body_launches`` counts the dense
calls per body.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels._build import Library, raise_on

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 128
_DTYPES = (torch.float32, torch.bfloat16)
_POOL_DTYPES = (torch.int8, torch.float8_e4m3fn)

_P = ctypes.c_void_p
_I = ctypes.c_int
LIBRARY = Library(SOURCE, {
    # q, k, v, o, kv_lens, q_offset, window, b, hq, hkv, sq, skv, d, causal,
    # scale, stream: the CUDA-core body (f32) and the tensor-core body (bf16)
    "flash_attention_dense": [_P] * 7 + [_I] * 7 + [ctypes.c_float, _P],
    "flash_attention_dense_tc": [_P] * 7 + [_I] * 7 + [ctypes.c_float, _P],
    # q, k, v, o, part, kv_lens, q_offset, window, b, hq, hkv, sq, skv, d,
    # causal, scale, splits, stream: the split-KV body (bf16)
    "flash_attention_dense_split": [_P] * 8 + [_I] * 7 + [ctypes.c_float, _I, _P],
    # q, k_pool, v_pool, o, table, kv_lens, q_offset, window, b, hq, hkv, sq,
    # d, page_size, n_pages, n_pool, causal, scale, is_bf16, stream
    "flash_attention_paged": [_P] * 8 + [_I] * 9 + [ctypes.c_float, _I, _P],
    # q, k_pool, v_pool, k_scale, v_scale, o, table, kv_lens, q_offset,
    # window, b, hq, hkv, sq, d, page_size, n_pages, n_pool, causal, scale,
    # is_bf16, is_fp8, stream
    "flash_attention_paged_quant": [_P] * 10 + [_I] * 9
                                   + [ctypes.c_float, _I, _I, _P],
})


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _check_common(q, tensors: dict, ints: dict, b: int):
    _check(q.is_cuda, f"q must be a CUDA tensor, got {q.device}")
    _check(q.dtype in _DTYPES, f"q dtype {q.dtype} not in {_DTYPES}")
    _check(q.dim() == 4, f"q must be (B, Hq, Sq, D), got {tuple(q.shape)}")
    _check(q.shape[-1] <= MAX_HEAD_DIM,
           f"head dim {q.shape[-1]} > {MAX_HEAD_DIM}")
    for name, t in {"q": q, **tensors, **ints}.items():
        _check(t.device == q.device, f"{name} on {t.device}, q on {q.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    for name, t in tensors.items():
        _check(t.dtype == q.dtype, f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    for name, t in ints.items():
        _check(t.dtype == torch.int32, f"{name} must be int32, got {t.dtype}")
    _check(tuple(ints["kv_lens"].shape) == (b,), "kv_lens must be (B,)")
    _check(tuple(ints["q_offset"].shape) == (b,), "q_offset must be (B,)")
    _check(tuple(ints["window"].shape) == (1,), "window must be (1,)")


# The dense kernel's three bodies; the wrapper picks one by ``plan_dense``.
TENSOR_CORE, SPLIT_KV, CUDA_CORE = "tensor_core", "split_kv", "cuda_core"
BODIES = (TENSOR_CORE, SPLIT_KV, CUDA_CORE)
SPLIT_ROWS = 16        # most rows (group * Sq) the split-KV body serves
MIN_SPLIT_KEYS = 128   # fewest cache keys per split
TARGET_CTAS = 1024     # split-KV CTAs to aim for: ~8 per SM of an H100
MAX_SPLITS = 64


class DensePlan(NamedTuple):
    """How the dense kernel runs one call.  ``body``: one of ``BODIES``;
    ``splits``: CTAs per (KV head, lane) of the split-KV body, each over an
    equal contiguous share of the lane's live keys, which the kernel computes
    on the card from kv_lens, q_offset and the window; ``scratch``: the
    shape of the f32 (m, l, acc) partials the split-KV body writes (None for
    the others)."""
    body: str
    splits: int
    scratch: tuple | None


def plan_dense(dtype, b: int, hq: int, hkv: int, sq: int, skv: int,
               d: int) -> DensePlan:
    """The dense kernel's plan for q (b, hq, sq, d) over k/v (b, hkv, skv, d).

    f32 takes the CUDA-core body (the tensor cores would run it as TF32).
    bf16 with at most ``SPLIT_ROWS`` rows per KV head (group * Sq: decode)
    takes the split-KV body with enough splits to fill the card, at least
    ``MIN_SPLIT_KEYS`` cache keys each; other bf16 calls (prefill) the
    tensor-core body, 64 query rows of one head per CTA."""
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype} not in {_DTYPES}")
    if d > MAX_HEAD_DIM or hq % hkv:
        raise ValueError(f"unsupported shape: Hq={hq}, Hkv={hkv}, D={d}")
    if dtype == torch.float32:
        return DensePlan(CUDA_CORE, 1, None)
    rows = (hq // hkv) * sq
    if rows <= SPLIT_ROWS:
        want = -(-TARGET_CTAS // (b * hkv))
        splits = max(1, min(want, skv // MIN_SPLIT_KEYS, MAX_SPLITS))
        return DensePlan(SPLIT_KV, splits, (b, hkv, splits, rows, d + 2))
    return DensePlan(TENSOR_CORE, 1, None)


def flash_dense_cuda(q, k, v, kv_lens, q_offset, window, *, causal: bool,
                     scale: float):
    """Dense kernel: q (B,Hq,Sq,D), k/v (B,Hkv,Skv,D) -> (B,Hq,Sq,D) in q's
    dtype.  ``kv_lens``/``q_offset`` (B,) and ``window`` (1,) int32.  The
    body is ``plan_dense``'s; each call adds one to ``launches`` and to its
    body's count in ``body_launches``."""
    b, hq, sq, d = q.shape
    _check_common(q, {"k": k, "v": v},
                  {"kv_lens": kv_lens, "q_offset": q_offset, "window": window}, b)
    _check(k.dim() == 4 and k.shape == v.shape, "k, v must be equal (B,Hkv,Skv,D)")
    _check(k.shape[0] == b and k.shape[3] == d, "k/v batch or head dim != q's")
    hkv, skv = k.shape[1], k.shape[2]
    _check(hq % hkv == 0, f"Hq={hq} is not a multiple of Hkv={hkv}")
    plan = plan_dense(q.dtype, b, hq, hkv, sq, skv, d)
    out = torch.empty_like(q)
    lib = LIBRARY.get()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    ints = (kv_lens.data_ptr(), q_offset.data_ptr(), window.data_ptr(),
            b, hq, hkv, sq, skv, d, int(causal), float(scale))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if plan.body == SPLIT_KV:
        part = torch.empty(plan.scratch, dtype=torch.float32, device=q.device)
        err = lib.flash_attention_dense_split(*ptrs, part.data_ptr(), *ints,
                                              plan.splits, stream)
        name = "flash_attention_dense_split"
    elif plan.body == TENSOR_CORE:
        err = lib.flash_attention_dense_tc(*ptrs, *ints, stream)
        name = "flash_attention_dense_tc"
    else:
        err = lib.flash_attention_dense(*ptrs, *ints, stream)
        name = "flash_attention_dense"
    raise_on(err, name)
    flash_dense_cuda.launches += 1
    flash_dense_cuda.body_launches[plan.body] += 1
    return out


def reset_dense_counts():
    """Set the dense kernel's launch counts, total and per body, to 0."""
    flash_dense_cuda.launches = 0
    flash_dense_cuda.body_launches = dict.fromkeys(BODIES, 0)


def _check_pools(q, k_pool, v_pool, page_table):
    b, hq, _, d = q.shape
    _check(k_pool.dim() == 4 and k_pool.shape == v_pool.shape,
           "k_pool, v_pool must be equal (P,Hkv,ps,D)")
    _check(k_pool.shape[3] == d, "pool head dim != q's")
    hkv = k_pool.shape[1]
    _check(hq % hkv == 0, f"Hq={hq} is not a multiple of Hkv={hkv}")
    _check(page_table.dim() == 2 and page_table.shape[0] == b,
           "page_table must be (B, n_pages)")


def flash_paged_cuda(q, k_pool, v_pool, page_table, kv_lens, q_offset, window,
                     *, causal: bool, scale: float):
    """Paged kernel: q (B,Hq,Sq,D), pools (P,Hkv,ps,D), page_table
    (B,n_pages) int32 -> (B,Hq,Sq,D) in q's dtype."""
    b, hq, sq, d = q.shape
    _check_common(q, {"k_pool": k_pool, "v_pool": v_pool},
                  {"kv_lens": kv_lens, "q_offset": q_offset, "window": window,
                   "page_table": page_table}, b)
    _check_pools(q, k_pool, v_pool, page_table)
    n_pool, hkv, ps = k_pool.shape[:3]
    n_pages = page_table.shape[1]
    out = torch.empty_like(q)
    lib = LIBRARY.get()
    err = lib.flash_attention_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        page_table.data_ptr(), kv_lens.data_ptr(), q_offset.data_ptr(),
        window.data_ptr(), b, hq, hkv, sq, d, ps, n_pages, n_pool,
        int(causal), float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(err, "flash_attention_paged")
    flash_paged_cuda.launches += 1
    return out


def flash_paged_quant_cuda(q, k_pool, v_pool, k_scale, v_scale, page_table,
                           kv_lens, q_offset, window, *, causal: bool,
                           scale: float):
    """Paged kernel over QUANTIZED pools: q (B,Hq,Sq,D) f32/bf16; pools
    (P,Hkv,ps,D) int8 or float8_e4m3fn; scales (P,Hkv,ps) f32; page_table
    (B,n_pages) int32 -> (B,Hq,Sq,D) in q's dtype.  Each K/V element widens
    to ``float(x) * scale[page, head, slot]`` in f32.  D must be a multiple
    of 16 (64, 80 and 128 on the serving path)."""
    b, hq, sq, d = q.shape
    _check_common(q, {}, {"kv_lens": kv_lens, "q_offset": q_offset,
                          "window": window, "page_table": page_table}, b)
    for name, t in {"k_pool": k_pool, "v_pool": v_pool, "k_scale": k_scale,
                    "v_scale": v_scale}.items():
        _check(t.device == q.device, f"{name} on {t.device}, q on {q.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(k_pool.dtype in _POOL_DTYPES and v_pool.dtype == k_pool.dtype,
           f"pool dtypes {k_pool.dtype}/{v_pool.dtype}: both must be one of "
           f"{_POOL_DTYPES}")
    _check(k_scale.dtype == torch.float32 and v_scale.dtype == torch.float32,
           "k_scale, v_scale must be float32")
    _check_pools(q, k_pool, v_pool, page_table)
    _check(tuple(k_scale.shape) == tuple(k_pool.shape[:3])
           and k_scale.shape == v_scale.shape,
           f"scales must be (P,Hkv,ps) = {tuple(k_pool.shape[:3])}")
    # narrow K/V are read 16 elements (16 bytes) at a time
    _check(d % 16 == 0, f"head dim {d} of a quantized pool is not a multiple of 16")
    _check(k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0,
           "quantized pools must start on a 16-byte boundary")
    n_pool, hkv, ps = k_pool.shape[:3]
    n_pages = page_table.shape[1]
    out = torch.empty_like(q)
    lib = LIBRARY.get()
    err = lib.flash_attention_paged_quant(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(), page_table.data_ptr(),
        kv_lens.data_ptr(), q_offset.data_ptr(), window.data_ptr(), b, hq, hkv,
        sq, d, ps, n_pages, n_pool, int(causal), float(scale),
        int(q.dtype == torch.bfloat16), int(k_pool.dtype == torch.float8_e4m3fn),
        torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(err, "flash_attention_paged_quant")
    flash_paged_quant_cuda.launches += 1
    return out


reset_dense_counts()
flash_paged_cuda.launches = 0
flash_paged_quant_cuda.launches = 0
