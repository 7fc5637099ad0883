"""Public flash-attention op: argument defaults, the page-table clamp, and the
route to the hand-written kernel or the plain version.

Routing: a CUDA tensor goes to the CUDA kernel (which launches or raises —
nothing falls back), a CPU tensor to the plain PyTorch version in ``ref``.
``impl="naive"`` always takes the plain version (tests and the on-card
comparison); ``"kernel"`` and ``"xla"`` (the config default, kept so config
files read as in the JAX package) both route by device.  The CUDA kernels
mask their own ragged edges, so nothing is padded to block sizes here.

Gradients: when grad mode is on and q, k or v requires grad, a dense call
(``impl`` other than ``"naive"``) goes through ``_FlashAttention``, the port
of the JAX package's custom VJP (``xla_impl._flash``): its forward also
keeps each row's log-sum-exp (the CUDA kernel's ``lse`` instance on the
card, ``ref.flash_fwd_lse`` on the CPU) and its backward is the two-pass
``flash_bwd_cuda`` on the card, ``ref.flash_bwd`` on the CPU.  Serving runs
under ``torch.inference_mode()`` and never takes it; paged mode is
forward-only, as in JAX.
"""

from __future__ import annotations

import torch

from repro_torch.core import paging as _paging

from . import kernel as _kernel
from . import ref as _ref

NO_WINDOW = 2 ** 30
IMPLS = ("kernel", "xla", "naive")


def _defaults(b, sq, skv, kv_lens, q_offset, causal, device):
    if kv_lens is None:
        kv_lens = torch.full((b,), skv, dtype=torch.int32, device=device)
    else:
        kv_lens = torch.as_tensor(kv_lens, device=device).to(torch.int32)
    if q_offset is None:
        off = skv - sq if causal else 0       # suffix alignment under causal
        q_offset = torch.full((b,), off, dtype=torch.int32, device=device)
    else:
        q_offset = torch.as_tensor(q_offset, device=device).to(
            torch.int32).expand(b)
    return kv_lens.contiguous(), q_offset.contiguous()


def _window_vec(window, device):
    if isinstance(window, torch.Tensor):
        return window.to(device=device, dtype=torch.int32).reshape(1)
    # a fill, not a tensor made from a host int: that would be a blocking
    # host-to-device copy on every call
    w = NO_WINDOW if window is None else int(window)
    return torch.full((1,), w, dtype=torch.int32, device=device)


class _FlashAttention(torch.autograd.Function):
    """Dense flash attention with the JAX package's flash backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, q_offset, window, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if q.is_cuda:
            out, lse = _kernel.flash_dense_lse_cuda(
                q, k, v, kv_lens, q_offset, window, causal=causal, scale=scale)
        else:
            out, lse = _ref.flash_fwd_lse(q, k, v, kv_lens=kv_lens,
                                          q_offset=q_offset, window=window[0],
                                          causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse, kv_lens, q_offset, window)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kv_lens, q_offset, window = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        if q.is_cuda:
            dq, dk, dv = _kernel.flash_bwd_cuda(
                q, k, v, out, dout, lse, kv_lens, q_offset, window,
                causal=ctx.causal, scale=ctx.scale)
        else:
            dq, dk, dv = _ref.flash_bwd(q, k, v, out, dout, lse,
                                        kv_lens=kv_lens, q_offset=q_offset,
                                        window=window[0], causal=ctx.causal,
                                        scale=ctx.scale)
        return dq, dk, dv, None, None, None, None, None


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _use_plain(q, impl):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "naive" or not q.is_cuda


def flash_attention(q, k, v, *, kv_lens=None, causal: bool = False,
                    window=None, q_offset=None, scale: float | None = None,
                    impl: str = "kernel", page_table=None, k_scale=None,
                    v_scale=None, decode: bool = False):
    """Predicated attention.  q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D).

    - ``kv_lens``: (B,) valid KV lengths (default Skv).
    - ``causal`` / ``window``: mask predicates (window = sliding local size,
      an int or 0-d tensor; None = no window).
    - ``q_offset``: (B,) absolute position of the first query row; defaults
      to Skv - Sq under ``causal`` (suffix alignment), else 0.
    - ``page_table``: (B, n_pages) int32 — PAGED mode: ``k``/``v`` are page
      pools (P, Hkv, page_size, D) read through the table.
    - ``k_scale`` / ``v_scale``: (P, Hkv, page_size) f32 scale pools of a
      QUANTIZED paged cache (int8 or float8_e4m3fn pools): K/V widen to
      ``q8 * scale`` at the point of use.  Paged mode only.
    - ``decode``: the call is a decode step (one new token per lane), not a
      prefill or a chunk of one; the kernels pick their body by it
      (``kernel.plan_dense`` / ``plan_paged``), never by the row count.
    """
    if page_table is not None:
        return _flash_paged(q, k, v, page_table, kv_lens=kv_lens,
                            causal=causal, window=window, q_offset=q_offset,
                            scale=scale, impl=impl, k_scale=k_scale,
                            v_scale=v_scale, decode=decode)
    if k_scale is not None or v_scale is not None:
        raise ValueError("quantized K/V scales require page_table (paged mode)")
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    kv_lens, q_offset = _defaults(b, sq, skv, kv_lens, q_offset, causal,
                                  q.device)
    scale_f = float(d ** -0.5) if scale is None else float(scale)
    if impl in IMPLS and impl != "naive" and _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, kv_lens, q_offset,
                                     _window_vec(window, q.device), causal,
                                     scale_f)
    if _use_plain(q, impl):
        return _ref.mha_ref(q, k, v, kv_lens=kv_lens, causal=causal,
                            window=window, q_offset=q_offset, scale=scale)
    return _kernel.flash_dense_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(), kv_lens, q_offset,
        _window_vec(window, q.device), causal=causal, scale=scale_f,
        decode=decode)


def _flash_paged(q, k_pool, v_pool, page_table, *, kv_lens, causal, window,
                 q_offset, scale, impl, k_scale=None, v_scale=None,
                 decode=False):
    """Paged dispatch: pools + page table instead of dense K/V; narrow pools
    with their scale pools when quantized."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("a quantized cache needs both k_scale and v_scale")
    b, hq, sq, d = q.shape
    ps = k_pool.shape[2]
    n_pages = page_table.shape[1]
    skv = n_pages * ps                               # logical KV extent
    kv_lens, q_offset = _defaults(b, sq, skv, kv_lens, q_offset, causal,
                                  q.device)
    # out-of-strip entries may be stale (freed and reallocated ids): clamp
    # them to page 0 before anything follows the table; the element
    # predicate masks their keys regardless
    page_table = torch.where(_paging.page_whilelt(kv_lens, n_pages, ps),
                             page_table.to(torch.int32), 0)
    if _use_plain(q, impl):
        # the extending gather widens a quantized pool to f32 here
        k = _paging.gather_pages(k_pool, page_table, scale=k_scale)
        v = _paging.gather_pages(v_pool, page_table, scale=v_scale)
        return _ref.mha_ref(q, k, v, kv_lens=kv_lens, causal=causal,
                            window=window, q_offset=q_offset, scale=scale)
    args = (q.contiguous(), k_pool.contiguous(), v_pool.contiguous())
    kw = dict(causal=causal,
              scale=float(d ** -0.5) if scale is None else float(scale),
              decode=decode)
    rest = (page_table.contiguous(), kv_lens, q_offset,
            _window_vec(window, q.device))
    if k_scale is not None:
        return _kernel.flash_paged_quant_cuda(
            *args, k_scale.contiguous(), v_scale.contiguous(), *rest, **kw)
    return _kernel.flash_paged_cuda(*args, *rest, **kw)
