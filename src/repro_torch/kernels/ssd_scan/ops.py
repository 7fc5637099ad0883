"""Public SSD ops: the ``seq_lens`` predicate, the ``D`` skip and the route
to the hand-written kernel or the plain version; and the single-token decode
step.

Routing, as in ``flash_attention.ops``: a CUDA tensor goes to the CUDA
kernel (which launches or raises: nothing falls back), a CPU tensor to the
plain ``ssd_chunked_ref``.  ``impl="naive"`` always takes the plain version
(tests and the on-card comparison); ``"kernel"`` and ``"xla"`` (the config
default, kept so config files read as in the JAX package) both route by
device.  The plain path pads S to a multiple of ``chunk`` as the JAX op
does; the kernel masks its own ragged edge, with the same result.

Gradients: when grad mode is on and an input requires grad, a call other
than ``impl="naive"`` goes through ``_SSDScan``.  Its forward is the route
above (the CUDA kernel on the card); its backward recomputes the plain
chunked scan under ``torch.enable_grad()`` and takes that graph's gradient,
the gradient JAX takes (autodiff of ``ssd_chunked_ref``).  A hand-written
SSD backward is later work (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import vla

from . import kernel as _kernel
from .ref import ssd_chunked_ref, ssd_ref  # noqa: F401  (oracle re-export)

IMPLS = ("kernel", "xla", "naive")


def ssd_scan(x, dt, A, B, C, D=None, *, seq_lens=None, h0=None,
             chunk: int = 128, impl: str = "kernel"):
    """Chunk-size-agnostic SSD scan.

    x: (Bz, S, H, P); dt: (Bz, S, H) (positive; e.g. softplus upstream);
    A: (H,) negative; B, C: (Bz, S, N); D: (H,) skip or None;
    seq_lens: (Bz,) ragged valid lengths, implemented by *predicating dt to
    zero* past each row's end (the state then carries unchanged and those
    steps contribute nothing); h0: (Bz, H, P, N) initial state or None.

    Returns (y, h_final): y (Bz, S, H, P) in x's dtype, h_final f32.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    bz, s, h, p = x.shape
    dt = dt.float()
    if seq_lens is not None:
        pos = torch.arange(s, dtype=torch.int32, device=dt.device)[None, :, None]
        lens = torch.as_tensor(seq_lens, device=dt.device).to(torch.int32)
        dt = torch.where(pos < lens[:, None, None], dt, 0.0)
    if h0 is None:
        h0 = torch.zeros((bz, h, p, B.shape[-1]), dtype=torch.float32,
                         device=x.device)

    if impl == "naive":
        y, hT = _plain(x, dt, A, B, C, h0, chunk)
    elif torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C, h0)):
        y, hT = _SSDScan.apply(x, dt, A, B, C, h0, chunk)
    else:
        y, hT = _scan(x, dt, A, B, C, h0, chunk)

    if D is not None:
        y = (y.float() + D.float()[None, None, :, None] * x.float()).to(y.dtype)
    return y, hT


def _plain(x, dt, A, B, C, h0, chunk):
    """The plain chunked scan, S padded to a multiple of ``chunk`` with
    inert (dt = 0) steps."""
    s = x.shape[1]
    pad = vla.pad_to_vl(s, chunk) - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    y, hT = ssd_chunked_ref(x, dt, A, B, C, None, h0=h0, chunk=chunk)
    return y[:, :s], hT


def _scan(x, dt, A, B, C, h0, chunk):
    """The forward route: the kernel for a CUDA tensor, else the plain scan."""
    if not x.is_cuda:
        return _plain(x, dt, A, B, C, h0, chunk)
    return _kernel.ssd_scan_cuda(
        _aligned(x), dt.contiguous(), A.float().contiguous(),
        _aligned(B.to(x.dtype)), _aligned(C.to(x.dtype)),
        _aligned(h0.float()), chunk=chunk)


class _SSDScan(torch.autograd.Function):
    """The scan with JAX's gradient: forward by ``_scan``, backward by
    autograd through the recomputed plain scan."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, h0, chunk):
        ctx.save_for_backward(x, dt, A, B, C, h0)
        ctx.chunk = chunk
        return _scan(x, dt, A, B, C, h0, chunk)

    @staticmethod
    def backward(ctx, gy, gh):
        saved = ctx.saved_tensors
        want = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(w) for t, w in zip(saved, want)]
            y, hT = _plain(*ins, ctx.chunk)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad((y, hT), wrt, (gy, gh),
                                             allow_unused=True))
        out = [next(grads) if w else None for w in want]
        out = [torch.zeros_like(t) if w and g is None else g
               for t, w, g in zip(saved, want, out)]
        return (*out, None)


def _aligned(t):
    """``t`` contiguous and starting on a 16-byte boundary (the kernel copies
    rows 16 bytes at a time): a view that is neither is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_decode_step(x_t, dt_t, A, B_t, C_t, h, D=None):
    """One-token SSD recurrence for serving, in plain PyTorch (the JAX
    package has no Pallas kernel for it either).

    x_t: (Bz, H, P); dt_t: (Bz, H); B_t, C_t: (Bz, N); h: (Bz, H, P, N).
    Returns (y_t in x_t's dtype, h_new f32)."""
    decay = torch.exp(dt_t.float() * A.float()[None, :])            # (Bz,H)
    upd = (dt_t.float()[..., None, None] * x_t.float()[..., :, None]
           * B_t.float()[:, None, None, :])
    h_new = decay[..., None, None] * h.float() + upd
    # a sum over the last dim, not a batched product: a batched product's
    # algorithm (and so a lane's bits) changes with the batch on the card
    y = (h_new * C_t.float()[:, None, None, :]).sum(-1)
    if D is not None:
        y = y + D.float()[None, :, None] * x_t.float()
    return y.to(x_t.dtype), h_new
