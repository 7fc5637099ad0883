"""The hand-written Hopper flash-attention kernels and their ctypes wrappers.

``csrc/flash_attention.cu`` holds the kernels (dense, paged, and paged over
int8/fp8 pools) (its header says which TPU
kernel each replaces and what bounds it).  ``kernels._build`` compiles it at
first use with ``nvcc`` for ``sm_90a`` into ``build/`` at the repo root,
named by the hash of the source so an edited source rebuilds, and loads it
with ``ctypes``.

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, raise on anything the kernel does not take, allocate the output
with ``torch.empty`` and launch on the current stream.  Each keeps a plain
integer launch count (``flash_dense_cuda.launches``,
``flash_paged_cuda.launches``, ``flash_paged_quant_cuda.launches``) that
grows by one per launch.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

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
    # scale, is_bf16, stream
    "flash_attention_dense": [_P] * 7 + [_I] * 7 + [ctypes.c_float, _I, _P],
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


def flash_dense_cuda(q, k, v, kv_lens, q_offset, window, *, causal: bool,
                     scale: float):
    """Dense kernel: q (B,Hq,Sq,D), k/v (B,Hkv,Skv,D) -> (B,Hq,Sq,D) in q's
    dtype.  ``kv_lens``/``q_offset`` (B,) and ``window`` (1,) int32."""
    b, hq, sq, d = q.shape
    _check_common(q, {"k": k, "v": v},
                  {"kv_lens": kv_lens, "q_offset": q_offset, "window": window}, b)
    _check(k.dim() == 4 and k.shape == v.shape, "k, v must be equal (B,Hkv,Skv,D)")
    _check(k.shape[0] == b and k.shape[3] == d, "k/v batch or head dim != q's")
    hkv, skv = k.shape[1], k.shape[2]
    _check(hq % hkv == 0, f"Hq={hq} is not a multiple of Hkv={hkv}")
    out = torch.empty_like(q)
    lib = LIBRARY.get()
    err = lib.flash_attention_dense(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        kv_lens.data_ptr(), q_offset.data_ptr(), window.data_ptr(),
        b, hq, hkv, sq, skv, d, int(causal), float(scale),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(err, "flash_attention_dense")
    flash_dense_cuda.launches += 1
    return out


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


flash_dense_cuda.launches = 0
flash_paged_cuda.launches = 0
flash_paged_quant_cuda.launches = 0
