"""MoE decoder LMs (olmoe-1b-7b, moonshot-v1-16b-a3b / Moonlight), mirroring
``repro.models.moe``.

GShard-style grouped dispatch: tokens are reshaped to (G groups, Tg, d),
routed to their top-k experts, ranked within each expert by the dispatch
kernel (``kernels.moe_dispatch``) and DROPPED past an expert's capacity.
Every position of the padded (B, S) batch is routed, pad positions
included, in token-major, slot-minor order, as in JAX, so the same
assignments drop.  The expert products run as batched matmuls over the
(G, E, C, d) buffers: every expert's C rows are computed whether or not
they are filled.

Layers run as a Python loop: ``MoELM.dense_blocks`` (the ``first_k_dense``
dense layers) then ``MoELM.blocks``.  The caches keep JAX's keys: a
``dense_k``/``dense_v`` stack of lead ``max(first_k_dense, 1)`` beside the
MoE stack ``k``/``v``, so a model with no dense layer still carries (and
pages) one unused dense slot, key for key with JAX.  Caches are updated IN
PLACE by ``prefill`` and ``decode``, which return the dict with the new
``pos``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import paging as PG
from repro_torch.core.device import resolve_device
from repro_torch.kernels.moe_dispatch import build_dispatch

from . import layers as L

# prefix sharing is OFF for MoE: grouped expert dispatch (capacity dropping)
# makes hidden states — and so cached K/V — depend on the batch composition
# of the donor's prefill
PAGED_PREFIX_OK = False
# chunked prefill of one prompt matches whole prefill whenever expert
# capacity does not drop
CHUNKED_PREFILL_OK = True
# expert capacity is shared across the batch: dropping (dead) lanes changes
# which tokens overflow an expert buffer, so bursts must run full-width
LANE_INDEPENDENT_DECODE = False


class MoEFFN(nn.Module):
    """Router (f32, (d, E)), expert weights stacked over experts
    (``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d)) and an optional
    shared MLP of width ``f * n_shared_experts``."""

    def __init__(self, cfg, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        dt = L.cdt(cfg)
        self.router = L._param((d, e), torch.float32, device)
        self.w_gate = L._param((e, d, f), dt, device)
        self.w_up = L._param((e, d, f), dt, device)
        self.w_down = L._param((e, f, d), dt, device)
        self.shared = (L.MLP(cfg, device, d_ff=f * cfg.n_shared_experts)
                       if cfg.n_shared_experts else None)

    def reset(self, cfg, generator):
        d, f = cfg.d_model, cfg.d_ff
        for w in (self.router, self.w_gate, self.w_up):
            L._normal_(w, d ** -0.5, generator)
        L._normal_(self.w_down, f ** -0.5, generator)
        if self.shared is not None:
            self.shared.reset(cfg, generator)


class MoEBlock(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.ln1 = L.Norm(cfg, cfg.d_model, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.Norm(cfg, cfg.d_model, device)
        self.moe = MoEFFN(cfg, device)

    def reset(self, cfg, generator):
        self.attn.reset(cfg, generator)
        self.moe.reset(cfg, generator)


class MoELM(nn.Module):
    """The MoE LM's weights: embedding, ``first_k_dense`` dense
    ``layers.Block``s, the ``MoEBlock``s, final norm."""

    def __init__(self, cfg, device):
        super().__init__()
        if cfg.family != "moe":
            raise ValueError(f"MoELM serves the moe family, got {cfg.family!r}")
        self.cfg = cfg
        self.embed = L.Embed(cfg, device)
        self.dense_blocks = nn.ModuleList(
            L.Block(cfg, device, d_ff=cfg.d_ff_dense or cfg.d_ff)
            for _ in range(cfg.first_k_dense))
        self.blocks = nn.ModuleList(MoEBlock(cfg, device)
                                    for _ in range(cfg.n_layers - cfg.first_k_dense))
        self.final_norm = L.Norm(cfg, cfg.d_model, device)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device


def init(cfg, generator: torch.Generator | None = None, device=None) -> MoELM:
    """Random weights with the scales of the JAX init (not its numbers).
    ``generator`` defaults to one on ``device`` seeded with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = MoELM(cfg, dev)
    model.embed.reset(cfg, generator)
    for blk in [*model.dense_blocks, *model.blocks]:
        blk.reset(cfg, generator)
    return model


# ---------------------------------------------------------------------------
# the MoE FFN (GShard grouped dispatch/combine)
# ---------------------------------------------------------------------------

def capacity(cfg, tokens_per_group: int) -> int:
    """Expert capacity C: ``capacity_factor`` times the even share, rounded
    up to a multiple of 8, at least 8."""
    c = math.ceil(tokens_per_group * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


def _router(p: MoEFFN, xt):
    """The f32 router logits of xt (..., d) and their softmax."""
    logits = xt.float() @ p.router.float()                 # (..., E)
    return logits, torch.softmax(logits, dim=-1)


def _top_k(probs, cfg):
    gates, ids = torch.topk(probs, cfg.top_k, dim=-1)       # sorted, as lax.top_k
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return gates, ids.to(torch.int32)


def route(p: MoEFFN, xt, cfg):
    """xt (..., d) -> (gates (..., K) f32 renormalised, ids (..., K)
    int32): softmax of the f32 router logits, then top-k."""
    return _top_k(_router(p, xt)[1], cfg)


def moe_ffn(p: MoEFFN, x, cfg, *, aux: bool = False):
    """x (B, S, d) -> y (B, S, d): all B*S positions form one dispatch
    group.  (The JAX function splits them into ``cfg.moe_groups`` groups,
    one per data shard; the port has no mesh.)  With ``aux`` (training)
    returns (y, metrics): the Switch load-balance loss ``lb_loss``, the
    router z-loss ``router_z`` and ``dropped_frac``, as JAX computes them.
    The gates keep their graph through the dispatch: only the integer
    ranks come from the kernel."""
    if cfg.moe_groups != 1:
        raise NotImplementedError(
            "moe_groups > 1 splits tokens over data shards; the port has no "
            "mesh yet (ROADMAP Queue 1 item 14)")
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    cap = capacity(cfg, t)
    cd = L.cdt(cfg)

    xt = x.reshape(t, d)
    logits, probs = _router(p, xt)
    gates, ids = _top_k(probs, cfg)
    disp = build_dispatch(ids, gates, e, cap)

    # gather tokens into expert buffers (E, C, d); row T is zero
    xp = torch.cat([xt, xt.new_zeros((1, d))])
    xe = xp[disp["token_table"].reshape(-1).long()].reshape(e, cap, d).to(cd)
    up = torch.einsum("ecd,edf->ecf", xe, p.w_up)
    gate = torch.einsum("ecd,edf->ecf", xe, p.w_gate)
    ye = torch.einsum("ecf,efd->ecd", F.silu(gate) * up, p.w_down)

    # combine back to token order; dropped lanes read the zero row E*C
    ye_flat = torch.cat([ye.reshape(e * cap, d), ye.new_zeros((1, d))])
    contrib = ye_flat[disp["slot_of"].reshape(-1).long()].reshape(t, k, d)
    y = (contrib * disp["gates"][..., None].to(contrib.dtype)).sum(dim=1)
    if p.shared is not None:
        y = y + L.mlp(p.shared, xt, cfg).to(y.dtype)
    y = y.reshape(b, s, d).to(x.dtype)
    if not aux:
        return y
    # Switch load balance (top-1 fraction x mean prob) and router z-loss
    f_e = F.one_hot(ids[:, 0].long(), e).float().mean(0)
    lb = e * (f_e * probs.mean(0)).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return y, {"lb_loss": lb, "router_z": z,
               "dropped_frac": disp["dropped"].float() / float(t * k)}


def moe_block_apply(p: MoEBlock, x, positions, cfg, *, kv_lens=None,
                    q_offset=None, cache=None, cache_pos=None, causal=True,
                    decode=False):
    h = L.apply_norm(p.ln1, x, cfg)
    attn_out, new_cache = L.attention(
        p.attn, h, positions, cfg, causal=causal, kv_lens=kv_lens,
        q_offset=q_offset, cache=cache, cache_pos=cache_pos, decode=decode)
    h2 = x + attn_out
    return h2 + moe_ffn(p.moe, L.apply_norm(p.ln2, h2, cfg), cfg), new_cache


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _n_dense_slots(cfg) -> int:
    return max(cfg.first_k_dense, 1)


def make_cache(cfg, batch_size: int, max_len: int, dtype=None, *, device):
    """Allocate the dense decode cache dict (zeros)."""
    dtype = dtype or L.cdt(cfg)
    shp = (batch_size, cfg.n_kv_heads, max_len, cfg.resolved_head_dim)
    n_moe = cfg.n_layers - cfg.first_k_dense
    z = lambda lead: torch.zeros((lead,) + shp, dtype=dtype, device=device)
    return {"dense_k": z(_n_dense_slots(cfg)), "dense_v": z(_n_dense_slots(cfg)),
            "k": z(n_moe), "v": z(n_moe),
            "pos": torch.zeros((batch_size,), dtype=torch.int32, device=device)}


def cache_batch_axes(cfg):
    """Which axis of each cache tensor is the request-lane (batch) axis."""
    return {"dense_k": 1, "dense_v": 1, "k": 1, "v": 1, "pos": 0}


def paged_decode_ok(cfg):
    """decode() reads every layer stack's K/V through the page table (the
    dense stack and the MoE stack share one page id space)."""
    return True


def paged_cache_spec(cfg):
    """Every KV tensor pages; one page id spans the dense AND MoE stacks."""
    n = _n_dense_slots(cfg)
    n_moe = cfg.n_layers - cfg.first_k_dense
    return {"dense_k": (n,), "dense_v": (n,), "k": (n_moe,), "v": (n_moe,)}


def make_paged_cache(cfg, batch_size: int, max_len: int, *, page_size: int,
                     pool_pages: int, dtype=None, page_dtype=None, device):
    """Paged decode cache: shared page pools (narrow + scale pools with
    ``page_dtype``) + per-lane page table + pos."""
    dtype = dtype or L.cdt(cfg)
    cache = PG.alloc_pools(paged_cache_spec(cfg), pool_pages, page_size,
                           cfg.n_kv_heads, cfg.resolved_head_dim, dtype,
                           device=device, page_dtype=page_dtype)
    cache["page_table"] = torch.zeros(
        (batch_size, PG.pages_needed(max_len, page_size)), dtype=torch.int32,
        device=device)
    cache["pos"] = torch.zeros((batch_size,), dtype=torch.int32, device=device)
    return cache


def _run(model: MoELM, cfg, x, positions, cache, *, kv_lens, q_offset,
         cache_pos, causal, decode):
    h = x
    for li, blk in enumerate(model.dense_blocks):
        h, _ = L.block_apply(blk, h, positions, cfg, causal=causal,
                             kv_lens=kv_lens, q_offset=q_offset,
                             cache=L.layer_cache(cache, "dense_", li),
                             cache_pos=cache_pos, decode=decode)
    for li, blk in enumerate(model.blocks):
        h, _ = moe_block_apply(blk, h, positions, cfg, kv_lens=kv_lens,
                               q_offset=q_offset,
                               cache=L.layer_cache(cache, "", li),
                               cache_pos=cache_pos, causal=causal,
                               decode=decode)
    return h


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with KV caches
# ---------------------------------------------------------------------------

def prefill(model: MoELM, cfg, batch, cache):
    """Run the prompt, fill the dense cache IN PLACE, return (last-token
    logits, cache).  batch: tokens (B, S), lens (B,) [+ pos0 (B,)]."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    lens = batch.get("lens")
    lens = (torch.full((b,), s, dtype=torch.int32, device=dev) if lens is None
            else torch.as_tensor(lens, device=dev).to(torch.int32))
    pos0 = batch.get("pos0")
    pos0 = (torch.zeros((b,), dtype=torch.int32, device=dev) if pos0 is None
            else torch.as_tensor(pos0, device=dev).to(torch.int32))
    positions = pos0[:, None] + torch.arange(s, dtype=torch.int32, device=dev)[None]
    x = L.embed(model.embed, tokens, cfg)
    h = _run(model, cfg, x, positions, cache, kv_lens=pos0 + lens,
             q_offset=pos0, cache_pos=pos0, causal=True, decode=False)
    cache = dict(cache)
    cache["pos"] = pos0 + lens
    h = L.apply_norm(model.final_norm, h, cfg)
    idx = (lens - 1).clamp(0, s - 1).long()
    h_last = h.gather(1, idx[:, None, None].expand(b, 1, h.shape[-1]))
    return L.unembed(model.embed, h_last, cfg)[:, 0], cache


def decode(model: MoELM, cfg, batch, cache):
    """One-token decode: batch = {"token": (B, 1)}.  Reads a dense cache or
    a paged one (full precision or quantized) natively; each layer writes
    its new K/V IN PLACE before attending.  Returns (logits, cache)."""
    pos = cache["pos"]
    x = L.embed(model.embed, batch["token"], cfg)
    h = _run(model, cfg, x, pos[:, None], cache, kv_lens=pos + 1,
             q_offset=pos, cache_pos=pos, causal=False, decode=True)
    cache = dict(cache)
    cache["pos"] = pos + 1
    h = L.apply_norm(model.final_norm, h, cfg)
    return L.unembed(model.embed, h, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _dense_body(blk, h, positions, cfg, kv_lens):
    return L.block_apply(blk, h, positions, cfg, causal=True,
                         kv_lens=kv_lens)[0]


def _moe_body(blk: MoEBlock, h, positions, cfg, kv_lens):
    attn_out, _ = L.attention(blk.attn, L.apply_norm(blk.ln1, h, cfg),
                              positions, cfg, causal=True, kv_lens=kv_lens)
    h2 = h + attn_out
    y, metrics = moe_ffn(blk.moe, L.apply_norm(blk.ln2, h2, cfg), cfg, aux=True)
    return h2 + y, metrics


def train_logits(model: MoELM, cfg, batch):
    """batch: tokens (B, S) [+ lens (B,)].  Returns (logits (B, S, V), aux):
    aux holds each router metric's mean over the MoE layers; each layer
    under ``layers.remat_wrap``, as in JAX."""
    tokens = batch["tokens"]
    kv_lens = batch.get("lens")
    positions = L.train_positions(tokens)
    h = L.embed(model.embed, tokens, cfg)
    dense_body = L.remat_wrap(_dense_body, cfg)
    for blk in model.dense_blocks:
        h = dense_body(blk, h, positions, cfg, kv_lens)
    body = L.remat_wrap(_moe_body, cfg)
    metrics = []
    for blk in model.blocks:
        h, m = body(blk, h, positions, cfg, kv_lens)
        metrics.append(m)
    aux = {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}
    h = L.apply_norm(model.final_norm, h, cfg)
    return L.unembed(model.embed, h, cfg), aux
