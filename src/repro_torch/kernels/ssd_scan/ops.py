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

    if impl == "naive" or not x.is_cuda:
        s_p = vla.pad_to_vl(s, chunk)
        xp, dtp, Bp, Cp = x, dt, B, C
        if s_p != s:
            pad = s_p - s                                # dt = 0: inert steps
            xp = F.pad(x, (0, 0, 0, 0, 0, pad))
            dtp = F.pad(dt, (0, 0, 0, pad))
            Bp = F.pad(B, (0, 0, 0, pad))
            Cp = F.pad(C, (0, 0, 0, pad))
        y, hT = ssd_chunked_ref(xp, dtp, A, Bp, Cp, None, h0=h0, chunk=chunk)
        y = y[:, :s]
    else:
        y, hT = _kernel.ssd_scan_cuda(
            _aligned(x), dt.contiguous(), A.float().contiguous(),
            _aligned(B.to(x.dtype)), _aligned(C.to(x.dtype)),
            _aligned(h0.float()), chunk=chunk)

    if D is not None:
        y = (y.float() + D.float()[None, None, :, None] * x.float()).to(y.dtype)
    return y, hT


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
    y = torch.einsum("bhpn,bn->bhp", h_new, C_t.float())
    if D is not None:
        y = y + D.float()[None, :, None] * x_t.float()
    return y.to(x_t.dtype), h_new
