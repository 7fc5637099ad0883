"""The hand-written Hopper flash-attention kernels and their ctypes wrappers.

``csrc/flash_attention.cu`` holds the kernels (its header says which TPU
kernel each replaces, what bounds it and what the design does about it).
``kernels._build`` compiles it at first use with ``nvcc`` for ``sm_90a``
into ``build/`` at the repo root, named by the hash of the source so an
edited source rebuilds, and loads it with ``ctypes``: one library for each
group of entry points (``LIBRARIES``), so the groups compile in parallel.

Each kernel has several bodies, chosen per call by ``plan_dense`` and
``plan_paged`` (plain Python, so the CPU tests see the route) from the
dtypes, the head shapes and the call's role, never from its row count: a
prefill row (a whole prompt or any chunk of it, one row included) takes
the same body whatever the call's length, so its bits do not depend on how
the prompt was cut.

- ``tensor_core``, dense bf16 prefill at any row count: 64 query rows per
  CTA, Q in registers, bf16 K/V tiles through a cp.async ring,
  ``mma.sync`` products with f32 accumulators; a row's bits depend only on
  its own position and keys.  Bound by operations.
- ``split_kv``, bf16 decode (at most 16 rows per KV head), dense K/V or
  paged pools (bf16, int8 or fp8): one body for both, split over the keys
  on a grid that only the lane's own keys decide (``lane_splits``), f32
  partials in scratch that this wrapper allocates, merged in split order by
  a second launch.  Bound by bytes.  Dense and paged calls over the same
  bf16 keys give the same bits, and a lane's bits do not depend on the
  other lanes of the call or on the cache's allocated length.
- ``cuda_core``, f32, and bf16 paged prefill (or paged decode of more than
  16 rows per KV head): the first design, f32 products on the CUDA cores (tensor cores
  would round f32 to TF32).

Training (``ops._FlashAttention``) runs the dense kernel through
``flash_dense_lse_cuda``, the ``cuda_core`` (f32) or ``tensor_core`` (bf16)
body compiled with a flag that also writes each row's log-sum-exp (the
serving instances compile without it; ``LSE_LIBRARY`` builds the training
instances from the same source on their own: ``LIBRARIES``), and
differentiates through
``flash_bwd_cuda``, the backward of ``csrc/flash_attention_bwd.cu``
(a source and a library of its own, ``BWD_LIBRARY``).

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, raise on anything the kernel does not take, allocate the output
with ``torch.empty`` and launch on the current stream.  Each keeps a plain
integer launch count (``flash_dense_cuda.launches``,
``flash_paged_cuda.launches``, ``flash_paged_quant_cuda.launches``,
``flash_bwd_cuda.launches``) that grows by one per call, and the calls per
body in ``body_launches`` (``flash_dense_lse_cuda`` counts as a call of
``flash_dense_cuda``).  The backward has two bodies (``plan_bwd``):
``tensor_core`` (bf16, ``mma.sync``) and ``cuda_core`` (f32).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels._build import Library, raise_on

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
MAX_HEAD_DIM = 160     # stablelm-12b's 5120 / 32, in every body
_DTYPES = (torch.float32, torch.bfloat16)
_POOL_DTYPES = (torch.int8, torch.float8_e4m3fn)

_P = ctypes.c_void_p
_I = ctypes.c_int
# The source's entry points in four groups, each built as a library of its
# own (a define selects the group; a group's instances are the same code in
# any build), all four compiled in parallel: the dense serving bodies, the
# split-KV body over pools, the CUDA-core body over pools, and training's
# forward with the rows' lse.
DENSE_LIBRARY = Library(SOURCE, {
    # q, k, v, o, kv_lens, q_offset, window, b, hq, hkv, sq, skv, d, causal,
    # scale, stream: the CUDA-core body (f32) and the tensor-core body (bf16)
    "flash_attention_dense": [_P] * 7 + [_I] * 7 + [ctypes.c_float, _P],
    "flash_attention_dense_tc": [_P] * 7 + [_I] * 7 + [ctypes.c_float, _P],
    # q, k, v, o, part, kv_lens, q_offset, window, b, hq, hkv, sq, skv, d,
    # causal, scale, splits, split_keys, max_splits, stream: the split-KV
    # body over dense bf16 K/V
    "flash_attention_dense_split": [_P] * 8 + [_I] * 7
                                   + [ctypes.c_float, _I, _I, _I, _P],
}, defines=("FLASH_BUILD_DENSE",))
PAGED_SPLIT_LIBRARY = Library(SOURCE, {
    # q, k_pool, v_pool, k_scale, v_scale, o, part, table, kv_lens,
    # q_offset, window, b, hq, hkv, sq, d, page_size, n_pages, n_pool,
    # causal, scale, splits, split_keys, max_splits, kv_kind, stream: the
    # split-KV body over bf16 (kv_kind 0), int8 (1) or fp8 (2) pools
    "flash_attention_paged_split": [_P] * 11 + [_I] * 9
                                   + [ctypes.c_float, _I, _I, _I, _I, _P],
}, defines=("FLASH_BUILD_PAGED_SPLIT",))
PAGED_LIBRARY = Library(SOURCE, {
    # q, k_pool, v_pool, o, table, kv_lens, q_offset, window, b, hq, hkv, sq,
    # d, page_size, n_pages, n_pool, causal, scale, is_bf16, stream
    "flash_attention_paged": [_P] * 8 + [_I] * 9 + [ctypes.c_float, _I, _P],
    # q, k_pool, v_pool, k_scale, v_scale, o, table, kv_lens, q_offset,
    # window, b, hq, hkv, sq, d, page_size, n_pages, n_pool, causal, scale,
    # is_bf16, is_fp8, stream
    "flash_attention_paged_quant": [_P] * 10 + [_I] * 9
                                   + [ctypes.c_float, _I, _I, _P],
}, defines=("FLASH_BUILD_PAGED",))
LSE_LIBRARY = Library(SOURCE, {
    # q, k, v, o, lse, kv_lens, q_offset, window, b, hq, hkv, sq, skv, d,
    # causal, scale, is_bf16, stream
    "flash_attention_dense_lse": [_P] * 8 + [_I] * 7 + [ctypes.c_float, _I, _P],
}, defines=("FLASH_BUILD_LSE",))
LIBRARIES = (DENSE_LIBRARY, PAGED_SPLIT_LIBRARY, PAGED_LIBRARY, LSE_LIBRARY)
# q, k, v, o, dout, lse, delta, dq, dk, dv, kv_lens, q_offset, window, b,
# hq, hkv, sq, skv, d, causal, scale, is_bf16, stream
BWD_LIBRARY = Library(BWD_SOURCE, {
    "flash_attention_bwd": [_P] * 13 + [_I] * 7 + [ctypes.c_float, _I, _P],
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


# The bodies; the wrappers pick one by ``plan_dense`` / ``plan_paged``.
TENSOR_CORE, SPLIT_KV, CUDA_CORE = "tensor_core", "split_kv", "cuda_core"
BODIES = (TENSOR_CORE, SPLIT_KV, CUDA_CORE)
PAGED_BODIES = (SPLIT_KV, CUDA_CORE)
BWD_BODIES = (TENSOR_CORE, CUDA_CORE)
SPLIT_ROWS = 16        # most rows (group * Sq) the split-KV body serves
SPLIT_KEYS = 128       # keys per split while a lane holds <= 64 splits of it
MAX_SPLITS = 64        # most splits of one lane: past it the span doubles
TILE_KEYS = 64         # keys per staged K/V tile


def split_span(kv_len: int) -> int:
    """Keys per split of a lane with ``kv_len`` cached keys: ``SPLIT_KEYS``,
    doubled until at most ``MAX_SPLITS`` splits cover ``kv_len``.  The
    kernel computes the same on the card from the lane's ``kv_lens``."""
    span = SPLIT_KEYS
    while -(-kv_len // span) > MAX_SPLITS:
        span *= 2
    return span


def lane_splits(kv_len: int, q_offset: int, sq: int, *, causal: bool,
                window: int | None = None) -> list:
    """The live splits of one lane, in order: ``(lo, hi)`` key ranges.

    Split ``s`` covers the absolute keys ``[s * span, (s + 1) * span)``
    (``span = split_span(kv_len)``, a multiple of the 64-key tile), cut to
    the keys some row of the lane may attend, ``[k_begin, k_end)`` from
    ``kv_len``, the causal edge and the window.  Nothing here depends on the
    batch, the KV heads or the cache's allocated length, so neither do the
    lane's bits.  Splits outside the range write nothing and the merge
    skips them."""
    k_begin = 0 if window is None else max(q_offset - window + 1, 0)
    k_end = min(kv_len, q_offset + sq) if causal else kv_len
    span = split_span(kv_len)
    if k_end <= k_begin:
        return []
    return [(max(s * span, k_begin), min((s + 1) * span, k_end))
            for s in range(k_begin // span, -(-k_end // span))]


def split_grid(skv: int) -> int:
    """CTAs per (KV head, lane) of the split-KV body over a cache of ``skv``
    keys: enough for the splits of any lane that fits in it."""
    return max(1, min(MAX_SPLITS, -(-skv // SPLIT_KEYS)))


class Plan(NamedTuple):
    """How a kernel runs one call.  ``body``: one of ``BODIES``; ``splits``:
    the split-KV body's grid of CTAs per (KV head, lane), each lane using
    the splits ``lane_splits`` names; ``scratch``: the shape of the f32
    (m, l, acc) partials the split-KV body writes, one row per split of the
    grid (None for the other bodies)."""
    body: str
    splits: int
    scratch: tuple | None


def _split_plan(b, hq, hkv, sq, skv, d) -> Plan:
    splits = split_grid(skv)
    return Plan(SPLIT_KV, splits,
                     (b, hkv, splits, (hq // hkv) * sq, d + 2))


def plan_dense(dtype, b: int, hq: int, hkv: int, sq: int, skv: int,
               d: int, *, decode: bool) -> Plan:
    """The dense kernel's plan for q (b, hq, sq, d) over k/v (b, hkv, skv, d).

    f32 takes the CUDA-core body (the tensor cores would run it as TF32).
    A bf16 decode call with at most ``SPLIT_ROWS`` rows per KV head
    (group * Sq) takes the split-KV body; every other bf16 call, and every
    prefill at any row count, the tensor-core body, 64 query rows of one
    head per CTA.  ``decode`` is the caller's: a one-row last chunk of a
    prompt has a decode step's shapes."""
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype} not in {_DTYPES}")
    if d > MAX_HEAD_DIM or hq % hkv:
        raise ValueError(f"unsupported shape: Hq={hq}, Hkv={hkv}, D={d}")
    if dtype == torch.float32:
        return Plan(CUDA_CORE, 1, None)
    if decode and (hq // hkv) * sq <= SPLIT_ROWS:
        return _split_plan(b, hq, hkv, sq, skv, d)
    return Plan(TENSOR_CORE, 1, None)


def plan_paged(dtype, pool_dtype, b: int, hq: int, hkv: int, sq: int,
               n_pages: int, page_size: int, d: int, *, decode: bool) -> Plan:
    """The paged kernel's plan for q (b, hq, sq, d) over (P, hkv, ps, d)
    pools of ``pool_dtype`` read through a (b, n_pages) table.

    A bf16 decode call with at most ``SPLIT_ROWS`` rows per KV head takes
    the split-KV body, the dense decode body itself walking the page table,
    over bf16, int8 and fp8 pools alike; f32 q and a bf16 prefill at any
    row count the CUDA-core body (f32 paged decode stays on the template of
    f32 dense decode).
    A narrow pool needs a head dim that is a multiple of 16."""
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype} not in {_DTYPES}")
    if pool_dtype != dtype and pool_dtype not in _POOL_DTYPES:
        raise ValueError(f"pool dtype {pool_dtype} is neither q's {dtype} "
                         f"nor one of {_POOL_DTYPES}")
    if d > MAX_HEAD_DIM or hq % hkv:
        raise ValueError(f"unsupported shape: Hq={hq}, Hkv={hkv}, D={d}")
    if pool_dtype in _POOL_DTYPES and d % 16:
        # narrow K/V are read 16 elements (16 bytes) at a time
        raise ValueError(f"head dim {d} of a quantized pool is not a "
                         "multiple of 16")
    if dtype == torch.bfloat16 and decode and (hq // hkv) * sq <= SPLIT_ROWS:
        return _split_plan(b, hq, hkv, sq, n_pages * page_size, d)
    return Plan(CUDA_CORE, 1, None)


def plan_bwd(dtype, d: int) -> str:
    """The backward's body: ``tensor_core`` (``mma.sync``) for bf16, at
    every head dim (past 128 dK and dV take a launch each), ``cuda_core``
    for f32 (the tensor cores would round it to TF32)."""
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype} not in {_DTYPES}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    return TENSOR_CORE if dtype == torch.bfloat16 else CUDA_CORE


def _check_dense(q, k, v, kv_lens, q_offset, window):
    b, hq, sq, d = q.shape
    _check_common(q, {"k": k, "v": v},
                  {"kv_lens": kv_lens, "q_offset": q_offset, "window": window}, b)
    _check(k.dim() == 4 and k.shape == v.shape, "k, v must be equal (B,Hkv,Skv,D)")
    _check(k.shape[0] == b and k.shape[3] == d, "k/v batch or head dim != q's")
    _check(hq % k.shape[1] == 0, f"Hq={hq} is not a multiple of Hkv={k.shape[1]}")


def flash_dense_cuda(q, k, v, kv_lens, q_offset, window, *, causal: bool,
                     scale: float, decode: bool = False):
    """Dense kernel: q (B,Hq,Sq,D), k/v (B,Hkv,Skv,D) -> (B,Hq,Sq,D) in q's
    dtype.  ``kv_lens``/``q_offset`` (B,) and ``window`` (1,) int32.  The
    body is ``plan_dense``'s; each call adds one to ``launches`` and to its
    body's count in ``body_launches``."""
    b, hq, sq, d = q.shape
    _check_dense(q, k, v, kv_lens, q_offset, window)
    hkv, skv = k.shape[1], k.shape[2]
    plan = plan_dense(q.dtype, b, hq, hkv, sq, skv, d, decode=decode)
    out = torch.empty_like(q)
    lib = DENSE_LIBRARY.get()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    ints = (kv_lens.data_ptr(), q_offset.data_ptr(), window.data_ptr(),
            b, hq, hkv, sq, skv, d, int(causal), float(scale))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if plan.body == SPLIT_KV:
        part = torch.empty(plan.scratch, dtype=torch.float32, device=q.device)
        err = lib.flash_attention_dense_split(*ptrs, part.data_ptr(), *ints,
                                              plan.splits, SPLIT_KEYS,
                                              MAX_SPLITS, stream)
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


def flash_dense_lse_cuda(q, k, v, kv_lens, q_offset, window, *, causal: bool,
                         scale: float):
    """Training's dense forward: ``flash_dense_cuda``'s prefill body (the
    CUDA-core body for f32, the tensor-core body for bf16) with the rows'
    log-sum-exp written out.  Returns (out (B,Hq,Sq,D) in q's dtype, lse
    (B,Hq,Sq) f32; -1e30 on a row with no live key).  Counted as a call of
    ``flash_dense_cuda``, in its body's ``body_launches``."""
    b, hq, sq, d = q.shape
    _check_dense(q, k, v, kv_lens, q_offset, window)
    hkv, skv = k.shape[1], k.shape[2]
    plan = plan_dense(q.dtype, b, hq, hkv, sq, skv, d, decode=False)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    err = LSE_LIBRARY.get().flash_attention_dense_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), kv_lens.data_ptr(), q_offset.data_ptr(),
        window.data_ptr(), b, hq, hkv, sq, skv, d, int(causal), float(scale),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(err, "flash_attention_dense_lse")
    flash_dense_cuda.launches += 1
    flash_dense_cuda.body_launches[plan.body] += 1
    return out, lse


def flash_bwd_cuda(q, k, v, out, dout, lse, kv_lens, q_offset, window, *,
                   causal: bool, scale: float):
    """The flash backward: q/out/dout (B,Hq,Sq,D), k/v (B,Hkv,Skv,D), all f32
    or all bf16; lse (B,Hq,Sq) f32 from ``flash_dense_lse_cuda`` ->
    (dq, dk, dv) in the inputs' dtype (f32 accumulation).  The body is
    ``plan_bwd``'s.  Three launches of ``BWD_LIBRARY`` per call (delta =
    rowsum(dO * O), the dQ pass, the dK/dV pass; four on the tensor-core
    body past head dim 128, dV and dK apart), no atomics: the same bits
    every call.  Each call adds one to ``launches`` and to its body's count
    in ``body_launches``."""
    b, hq, sq, d = q.shape
    _check_dense(q, k, v, kv_lens, q_offset, window)
    _check_common(q, {"out": out, "dout": dout}, {"kv_lens": kv_lens,
                  "q_offset": q_offset, "window": window}, b)
    _check(out.shape == q.shape and dout.shape == q.shape,
           "out and dout must have q's shape")
    _check(lse.dtype == torch.float32 and tuple(lse.shape) == (b, hq, sq)
           and lse.is_contiguous() and lse.device == q.device,
           "lse must be contiguous (B, Hq, Sq) f32 on q's device")
    hkv, skv = k.shape[1], k.shape[2]
    body = plan_bwd(q.dtype, d)
    if sq == 0 or skv == 0:
        dq = torch.zeros_like(q)
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    else:
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    err = BWD_LIBRARY.get().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), kv_lens.data_ptr(), q_offset.data_ptr(),
        window.data_ptr(), b, hq, hkv, sq, skv, d, int(causal), float(scale),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(err, "flash_attention_bwd")
    flash_bwd_cuda.launches += 1
    flash_bwd_cuda.body_launches[body] += 1
    return dq, dk, dv


def reset_flash_counts():
    """Set the flash kernels' launch counts, total and per body, to 0."""
    flash_dense_cuda.launches = 0
    flash_bwd_cuda.launches = 0
    flash_bwd_cuda.body_launches = dict.fromkeys(BWD_BODIES, 0)
    flash_dense_cuda.body_launches = dict.fromkeys(BODIES, 0)
    for fn in (flash_paged_cuda, flash_paged_quant_cuda):
        fn.launches = 0
        fn.body_launches = dict.fromkeys(PAGED_BODIES, 0)


def _check_pools(q, k_pool, v_pool, page_table):
    b, hq, _, d = q.shape
    _check(k_pool.dim() == 4 and k_pool.shape == v_pool.shape,
           "k_pool, v_pool must be equal (P,Hkv,ps,D)")
    _check(k_pool.shape[3] == d, "pool head dim != q's")
    hkv = k_pool.shape[1]
    _check(hq % hkv == 0, f"Hq={hq} is not a multiple of Hkv={hkv}")
    _check(page_table.dim() == 2 and page_table.shape[0] == b,
           "page_table must be (B, n_pages)")
    n_pool, _, ps = k_pool.shape[:3]
    # the split-KV body keeps a key's pool row index in an int
    _check(n_pool * hkv * ps < 2 ** 31, "pools of 2^31 key rows or more")


def _paged_split(q, k_pool, v_pool, k_scale, v_scale, page_table, kv_lens,
                 q_offset, window, plan, causal, scale):
    """Launch the split-KV body over pools (bf16, or narrow with scales)."""
    b, hq, sq, d = q.shape
    n_pool, hkv, ps = k_pool.shape[:3]
    out = torch.empty_like(q)
    part = torch.empty(plan.scratch, dtype=torch.float32, device=q.device)
    kind = {torch.bfloat16: 0, torch.int8: 1,
            torch.float8_e4m3fn: 2}[k_pool.dtype]
    scales = ((k_scale.data_ptr(), v_scale.data_ptr()) if kind else (None, None))
    err = PAGED_SPLIT_LIBRARY.get().flash_attention_paged_split(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *scales,
        out.data_ptr(), part.data_ptr(), page_table.data_ptr(),
        kv_lens.data_ptr(), q_offset.data_ptr(), window.data_ptr(), b, hq,
        hkv, sq, d, ps, page_table.shape[1], n_pool, int(causal),
        float(scale), plan.splits, SPLIT_KEYS, MAX_SPLITS, kind,
        torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(err, "flash_attention_paged_split")
    return out


def flash_paged_cuda(q, k_pool, v_pool, page_table, kv_lens, q_offset, window,
                     *, causal: bool, scale: float, decode: bool = False):
    """Paged kernel: q (B,Hq,Sq,D), pools (P,Hkv,ps,D) of q's dtype,
    page_table (B,n_pages) int32 -> (B,Hq,Sq,D) in q's dtype.  The body is
    ``plan_paged``'s; each call adds one to ``launches`` and to its body's
    count in ``body_launches``."""
    b, hq, sq, d = q.shape
    _check_common(q, {"k_pool": k_pool, "v_pool": v_pool},
                  {"kv_lens": kv_lens, "q_offset": q_offset, "window": window,
                   "page_table": page_table}, b)
    _check_pools(q, k_pool, v_pool, page_table)
    n_pool, hkv, ps = k_pool.shape[:3]
    n_pages = page_table.shape[1]
    plan = plan_paged(q.dtype, k_pool.dtype, b, hq, hkv, sq, n_pages, ps, d,
                      decode=decode)
    if plan.body == SPLIT_KV:
        out = _paged_split(q, k_pool, v_pool, None, None, page_table, kv_lens,
                           q_offset, window, plan, causal, scale)
    else:
        out = torch.empty_like(q)
        err = PAGED_LIBRARY.get().flash_attention_paged(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
            page_table.data_ptr(), kv_lens.data_ptr(), q_offset.data_ptr(),
            window.data_ptr(), b, hq, hkv, sq, d, ps, n_pages, n_pool,
            int(causal), float(scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
        raise_on(err, "flash_attention_paged")
    flash_paged_cuda.launches += 1
    flash_paged_cuda.body_launches[plan.body] += 1
    return out


def flash_paged_quant_cuda(q, k_pool, v_pool, k_scale, v_scale, page_table,
                           kv_lens, q_offset, window, *, causal: bool,
                           scale: float, decode: bool = False):
    """Paged kernel over QUANTIZED pools: q (B,Hq,Sq,D) f32/bf16; pools
    (P,Hkv,ps,D) int8 or float8_e4m3fn; scales (P,Hkv,ps) f32; page_table
    (B,n_pages) int32 -> (B,Hq,Sq,D) in q's dtype.  Each K/V element widens
    to ``float(x) * scale[page, head, slot]`` in f32.  D must be a multiple
    of 16 (64, 80, 128 and 160 on the serving path).  The body is
    ``plan_paged``'s, counted as in ``flash_paged_cuda``."""
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
    plan = plan_paged(q.dtype, k_pool.dtype, b, hq, hkv, sq, n_pages, ps, d,
                      decode=decode)
    if plan.body == SPLIT_KV:
        out = _paged_split(q, k_pool, v_pool, k_scale, v_scale, page_table,
                           kv_lens, q_offset, window, plan, causal, scale)
    else:
        out = torch.empty_like(q)
        err = PAGED_LIBRARY.get().flash_attention_paged_quant(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
            page_table.data_ptr(), kv_lens.data_ptr(), q_offset.data_ptr(),
            window.data_ptr(), b, hq, hkv, sq, d, ps, n_pages, n_pool,
            int(causal), float(scale), int(q.dtype == torch.bfloat16),
            int(k_pool.dtype == torch.float8_e4m3fn),
            torch.cuda.current_stream(q.device).cuda_stream)
        raise_on(err, "flash_attention_paged_quant")
    flash_paged_quant_cuda.launches += 1
    flash_paged_quant_cuda.body_launches[plan.body] += 1
    return out


reset_flash_counts()
