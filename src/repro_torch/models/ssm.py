"""Mamba2 (SSD) attention-free LM (mamba2-130m) and the block that the hybrid
family's backbone is made of, mirroring ``repro.models.ssm``.

Block: norm -> in_proj -> [z | xBC | dt] -> causal depthwise conv (xBC) ->
silu -> SSD scan (the CUDA kernel on the card) -> gated RMSNorm(y * silu(z))
-> out_proj.  Decode keeps a (W-1)-tap conv cache and the (H, P, N) f32 SSM
state: constant memory in sequence length.  Caches are dicts of tensors in
the JAX layouts, updated IN PLACE by ``prefill`` and ``decode``, which return
the dict with the new ``pos``.

Softplus is ``jax.nn.softplus``'s formula, max(x, 0) + log1p(exp(-|x|)).
``torch.nn.functional.softplus`` returns x itself above x = 20, where the
exact value differs by log1p(exp(-20)) ~ 2e-9, below half an f32 ulp of 20
(9.5e-7): the two agree at every dt this model can produce; the formula is
kept for parity's sake.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.device import resolve_device
from repro_torch.kernels.ssd_scan import ssd_decode_step, ssd_scan

from . import layers as L


def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


class GatedNorm(nn.Module):
    """Mamba2's RMSNormGated weights: one f32 scale."""

    def __init__(self, d: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device),
                                  requires_grad=False)


class MambaBlock(nn.Module):
    """One Mamba2 block, with the parameter names of the JAX
    ``mamba_block_init``.  Matmul and conv weights are held in the compute
    dtype; ``A_log``, ``D``, ``dt_bias`` and the norm scales in f32."""

    def __init__(self, cfg, device):
        super().__init__()
        d, di, h = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads
        cdim = conv_dim(cfg)
        cd = L.cdt(cfg)
        f32 = torch.float32
        self.norm = L.Norm(cfg, d, device)
        self.in_proj = L._param((d, di + cdim + h), cd, device)
        self.conv_w = L._param((cfg.ssm_conv_width, cdim), cd, device)
        self.conv_b = L._param((cdim,), cd, device)
        self.A_log = L._param((h,), f32, device)
        self.D = L._param((h,), f32, device)
        self.dt_bias = L._param((h,), f32, device)
        self.out_norm = GatedNorm(di, device)
        self.out_proj = L._param((di, d), cd, device)

    def reset(self, cfg, generator):
        """The JAX init's scales and constants (not its random numbers)."""
        d, di = cfg.d_model, cfg.d_inner
        L._normal_(self.in_proj, d ** -0.5, generator)
        L._normal_(self.conv_w, cfg.ssm_conv_width ** -0.5, generator)
        L._normal_(self.out_proj, di ** -0.5, generator)
        self.conv_b.zero_()
        self.A_log.zero_()                 # A = -exp(A_log) = -1
        self.D.fill_(1.0)
        self.dt_bias.fill_(-2.0)           # softplus(-2) ~ 0.13


def softplus(x):
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _split_proj(cfg, proj):
    di = cfg.d_inner
    z = proj[..., :di]
    xbc = proj[..., di:di + conv_dim(cfg)]
    dt = proj[..., di + conv_dim(cfg):]
    assert dt.shape[-1] == cfg.n_ssm_heads
    return z, xbc, dt


def _causal_conv(xbc, w, b, tail=None):
    """Depthwise causal conv: xbc (B, S, C), w (W, C) -> ((B, S, C), pad).

    ``tail`` is the previous (W-1) PRE-conv taps; None means a fresh
    sequence (zero left-pad).  The taps are added one at a time in the
    compute dtype, as in JAX, so bf16 rounds at the same places (and no
    cuDNN convolution runs, in TF32 or otherwise)."""
    width = w.shape[0]
    s = xbc.shape[1]
    if tail is None:
        pad = F.pad(xbc, (0, 0, width - 1, 0))
    else:
        pad = torch.cat([tail.to(xbc.dtype), xbc], dim=1)
    out = torch.zeros_like(xbc)
    for i in range(width):
        out = out + pad[:, i:i + s, :] * w[i][None, None, :]
    return out + b[None, None, :], pad


def _gated_out_norm(p: GatedNorm, y, z, cfg):
    """Mamba2 RMSNormGated: rmsnorm(y * silu(z)) * scale, in f32, on at
    least ``layers.NORM_ROW_FLOOR`` rows."""
    def norm(yf):
        ms = yf.square().mean(dim=-1, keepdim=True)
        return yf * torch.rsqrt(ms + cfg.norm_eps) * p.scale.float()
    return L.per_row(norm, y.float() * F.silu(z.float()),
                     L.NORM_ROW_FLOOR).to(y.dtype)


def mamba_block(p: MambaBlock, x, cfg, *, seq_lens=None, conv_init=None,
                state_init=None):
    """Full-sequence block.  Returns (out, (conv_tail, ssm_state)).

    ``conv_init`` (B, W-1, C) / ``state_init`` (B, H, P, N) resume from the
    carried conv taps and SSM state; None (or all-zero inits, as in a fresh
    cache) is a fresh sequence.  The conv tail holds PRE-conv taps: the last
    W-1 before each row's length."""
    b, s, _ = x.shape
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    cd = L.cdt(cfg)
    width = cfg.ssm_conv_width

    hin = L.apply_norm(p.norm, x, cfg)
    proj = L.linear(hin.to(cd), p.in_proj)
    z, xbc, dt = _split_proj(cfg, proj)
    conv_out, pre_taps = _causal_conv(xbc, p.conv_w, p.conv_b, tail=conv_init)
    xbc = F.silu(conv_out)
    x_in = xbc[..., :di].reshape(b, s, h, cfg.ssm_headdim)
    bmat = xbc[..., di:di + n]
    cmat = xbc[..., di + n:]
    dt = softplus(dt.float() + p.dt_bias[None, None, :])
    A = -torch.exp(p.A_log)

    y, hT = ssd_scan(x_in, dt, A, bmat, cmat, D=p.D, seq_lens=seq_lens,
                     h0=state_init, chunk=cfg.ssm_chunk, impl=cfg.ssd_impl)
    y = _gated_out_norm(p.out_norm, y.reshape(b, s, di), z, cfg)
    out = x + L.linear(y.to(cd), p.out_proj).to(x.dtype)

    # pre_taps = [init | pre-conv xBC]: a row of valid length l ends at index
    # (W-1)+l, so its last W-1 taps start at index l
    if seq_lens is None:
        tail = pre_taps[:, s:, :]
    else:
        start = torch.as_tensor(seq_lens, device=x.device).long()
        idx = start[:, None] + torch.arange(width - 1, device=x.device)[None]
        tail = pre_taps.gather(
            1, idx[:, :, None].expand(b, width - 1, pre_taps.shape[-1]))
    return out, (tail, hT)


def mamba_block_decode(p: MambaBlock, x_t, cfg, conv_cache, state):
    """One-token block.  x_t: (B, 1, d); conv_cache: (B, W-1, C); state f32.
    Returns (out, (new conv cache, new state))."""
    b = x_t.shape[0]
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    cd = L.cdt(cfg)

    hin = L.apply_norm(p.norm, x_t, cfg)
    proj = L.linear(hin.to(cd), p.in_proj)
    z, xbc, dt = _split_proj(cfg, proj)                       # (B, 1, *)
    window = torch.cat([conv_cache, xbc.to(conv_cache.dtype)], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", window.to(cd), p.conv_w) + p.conv_b
    xbc_t = F.silu(conv_out)                                  # (B, C)
    x_in = xbc_t[:, :di].reshape(b, h, cfg.ssm_headdim)
    bmat, cmat = xbc_t[:, di:di + n], xbc_t[:, di + n:]
    dt_t = softplus(dt[:, 0].float() + p.dt_bias[None, :])
    A = -torch.exp(p.A_log)

    y, state = ssd_decode_step(x_in, dt_t, A, bmat, cmat, state, D=p.D)
    y = _gated_out_norm(p.out_norm, y.reshape(b, 1, di), z, cfg)
    out = x_t + L.linear(y.to(cd), p.out_proj).to(x_t.dtype)
    return out, (window[:, 1:, :], state)


def run_block(p: MambaBlock, h, cfg, conv, state, *, lens, decode_step,
              live=None):
    """Apply one block (prefill or decode) and write its conv tail and SSM
    state IN PLACE into the cache views ``conv`` and ``state``.  With
    ``live`` (a 0-d bool tensor, a gated decode step) the carries are
    written only where it holds, so a step that is not live leaves them as
    they were without a host sync."""
    if decode_step:
        h, (tail, st) = mamba_block_decode(p, h, cfg, conv, state)
    else:
        h, (tail, st) = mamba_block(p, h, cfg, seq_lens=lens, conv_init=conv,
                                    state_init=state)
    if live is None:
        conv.copy_(tail)
        state.copy_(st)
    else:
        torch.where(live, tail, conv, out=conv)
        torch.where(live, st, state, out=state)
    return h


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------

def mamba_block_axes(cfg):
    """The JAX package's logical axes of a Mamba2 block: "ssm_inner" has no
    rule, so a block stays whole on every rank of a mesh."""
    return {"norm": L.norm_axes(cfg), "in_proj": ("embed", "ssm_inner"),
            "conv_w": (None, "ssm_inner"), "conv_b": ("ssm_inner",),
            "A_log": (None,), "D": (None,), "dt_bias": (None,),
            "out_norm": {"scale": ("ssm_inner",)},
            "out_proj": ("ssm_inner", "embed")}


def axes(cfg):
    """The logical-axis tree of the JAX package's ssm params."""
    return {"embed": L.embed_axes(cfg),
            "blocks": L.stack_axes(mamba_block_axes(cfg)),
            "final_norm": L.norm_axes(cfg)}


class SSMLM(nn.Module):
    """The ssm LM's weights: embedding, one ``MambaBlock`` per layer, final
    norm.  Built with uninitialised weights; ``init`` or
    ``convert.from_jax_params`` fills them."""

    def __init__(self, cfg, device):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"SSMLM serves the ssm family, got {cfg.family!r}")
        self.cfg = cfg
        self.embed = L.Embed(cfg, device)
        self.blocks = nn.ModuleList(MambaBlock(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = L.Norm(cfg, cfg.d_model, device)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device


def init(cfg, generator: torch.Generator | None = None, device=None) -> SSMLM:
    """Random weights with the scales of the JAX init (not its numbers).
    ``generator`` defaults to one on ``device`` seeded with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = SSMLM(cfg, dev)
    model.embed.reset(cfg, generator)
    for blk in model.blocks:
        blk.reset(cfg, generator)
    return model


def make_cache(cfg, batch_size: int, max_len: int = 0, dtype=None, *, device):
    """SSM caches are length-independent: conv tail + state (+ pos)."""
    dtype = dtype or L.cdt(cfg)
    return {
        "conv": torch.zeros((cfg.n_layers, batch_size, cfg.ssm_conv_width - 1,
                             conv_dim(cfg)), dtype=dtype, device=device),
        "state": torch.zeros((cfg.n_layers, batch_size, cfg.n_ssm_heads,
                              cfg.ssm_headdim, cfg.ssm_state),
                             dtype=torch.float32, device=device),
        "pos": torch.zeros((batch_size,), dtype=torch.int32, device=device),
    }


def cache_batch_axes(cfg):
    """Which axis of each cache tensor is the request-lane (batch) axis."""
    return {"conv": 1, "state": 1, "pos": 0}


# prefill() resumes the scan from the cached conv taps + SSM state (a fresh
# cache is all-zero, which is the same as no carry), so chunked prefill is
# exact — provided chunk boundaries land on multiples of ssm_chunk so the
# chunk sequence matches the unchunked scan
CHUNKED_PREFILL_OK = True
# decode has no cross-lane coupling: bursts may narrow to a lane prefix
LANE_INDEPENDENT_DECODE = True


def chunked_prefill_granularity(cfg) -> int:
    """Chunk boundaries must be multiples of the SSD scan chunk for the
    resumed scan to equal the whole-prompt scan (the same chunk sequence;
    the dt=0 padded tail steps are exact identities)."""
    return int(cfg.ssm_chunk)


def paged_cache_spec(cfg):
    """SSM caches are length-independent: nothing to page."""
    return {}


def make_paged_cache(cfg, batch_size: int, max_len: int = 0, *,
                     page_size: int = 0, pool_pages: int = 0, dtype=None,
                     page_dtype=None, device=None):
    raise ValueError(
        "ssm caches carry no per-token KV state; paging does not apply — "
        "serve this family with the dense cache (it is already O(1)/lane)")


def lens_pos0(batch, b, s, dev):
    lens = batch.get("lens")
    lens = (torch.full((b,), s, dtype=torch.int32, device=dev) if lens is None
            else torch.as_tensor(lens, device=dev).to(torch.int32))
    pos0 = batch.get("pos0")
    pos0 = (torch.zeros((b,), dtype=torch.int32, device=dev) if pos0 is None
            else torch.as_tensor(pos0, device=dev).to(torch.int32))
    return lens, pos0


def last_logits(model, cfg, h, lens):
    """Final norm, then the logits at each row's last valid position."""
    b, s, d = h.shape
    h = L.apply_norm(model.final_norm, h, cfg)
    idx = (lens - 1).clamp(0, s - 1).long()
    h_last = h.gather(1, idx[:, None, None].expand(b, 1, d))
    return L.unembed(model.embed, h_last, cfg)[:, 0]


def prefill(model: SSMLM, cfg, batch, cache):
    """Run the prompt from the cached carry (a fresh cache is all zero, the
    same as no carry), fill the cache IN PLACE, return (last-token logits,
    cache).  batch: tokens (B, S), lens (B,) [+ pos0 (B,)]."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    lens, pos0 = lens_pos0(batch, b, s, tokens.device)
    h = L.embed(model.embed, tokens, cfg)
    for li, blk in enumerate(model.blocks):
        h = run_block(blk, h, cfg, cache["conv"][li], cache["state"][li],
                      lens=lens, decode_step=False)
    cache = dict(cache)
    cache["pos"] = pos0 + lens
    return last_logits(model, cfg, h, lens), cache


def decode(model: SSMLM, cfg, batch, cache):
    """One-token decode: batch = {"token": (B, 1)} [+ "live", a 0-d bool:
    when False the step leaves the conv taps and SSM state as they were].
    Returns (logits, cache)."""
    h = L.embed(model.embed, batch["token"], cfg)
    for li, blk in enumerate(model.blocks):
        h = run_block(blk, h, cfg, cache["conv"][li], cache["state"][li],
                      lens=None, decode_step=True, live=batch.get("live"))
    cache = dict(cache)
    cache["pos"] = cache["pos"] + 1
    h = L.apply_norm(model.final_norm, h, cfg)
    return L.unembed(model.embed, h, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _block_body(blk, h, cfg, seq_lens):
    return mamba_block(blk, h, cfg, seq_lens=seq_lens)[0]


def train_logits(model: SSMLM, cfg, batch):
    """batch: tokens (B, S) [+ lens (B,)].  Returns (logits (B, S, V), {});
    each block under ``layers.remat_wrap``, as in JAX."""
    seq_lens = batch.get("lens")
    h = L.embed(model.embed, batch["tokens"], cfg)
    body = L.remat_wrap(_block_body, cfg)
    for blk in model.blocks:
        h = body(blk, h, cfg, seq_lens)
    h = L.apply_norm(model.final_norm, h, cfg)
    return L.unembed(model.embed, h, cfg), {}
