"""Shared model building blocks: ``nn.Module``s that hold the weights and
plain functions that apply them, mirroring ``repro.models.layers``.

Conventions
-----------
* Matmul weights are ``(in, out)`` and used as ``x @ w``.  They and the
  embedding table are held in ``cfg.compute_dtype``, cast once when the model
  is built — the same values as JAX's per-call ``.astype(compute_dtype)`` of
  its f32 master weights.  Norm parameters stay f32: ``apply_norm`` reads
  them in f32.
* Norms and rope run in f32; matmul inputs in the compute dtype.
* Caches are updated IN PLACE (``scatter_`` / slice assignment) where the JAX
  functions return fresh arrays; each function says so.
* A row's bits do not depend on how many rows share its call.  The
  projections and the norms run through ``per_row``, which gives them at
  least ``ROW_FLOOR`` and ``NORM_ROW_FLOOR`` rows: below those the card's
  GEMM and reduction kernels pick other algorithms (split-K, a row split
  over more threads) and round a row otherwise.  So a lane decodes the same bits in a burst of any width,
  and a prompt prefills the same bits whole, in a batch or in chunks — the
  contract ``LANE_INDEPENDENT_DECODE`` and chunked prefill rest on.
* Training (``repro_torch.train``) runs the same functions on f32 master
  weights cast to these dtypes per step (the embedding table stays f32: the
  gather casts its rows), with each layer body under ``remat_wrap``.
* Tensor-parallel serving (``dist.serve``): each ``*_axes`` gives the JAX
  package's logical axes of its module's weights, keyed by the port's
  parameter names.  A rank of a mesh holds the column-parallel weights cut
  into whole heads (wq, wk, wv), MLP columns (w_up, w_gate) and vocab
  rows of the table (and unembed columns), and wo and w_down whole.  The
  functions read head counts from the weights' shapes, and gather a cut
  activation before the product that needs it whole (the merged heads
  before wo, the MLP intermediate before w_down, the logits), in rank
  order, so every contraction runs whole and a rank's results are the
  one-device bits.
* Training on a mesh (``train.step``, ``DEFAULT_RULES``): wo and w_down
  are cut too (their contraction rows over "model"), so each rank's
  product is a partial one and ``sharding.from_model`` sums it (Megatron's
  g); every column-parallel product's input passes ``sharding.to_model``
  (f), whose backward sums the ranks' partial gradients.  The cut logits
  and embedding rows are gathered whole, and their gradients go back to
  the rank that owns each block.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.core import paging as PG
from repro_torch.dist import sharding as SH
from repro_torch.kernels.flash_attention import flash_attention


#: the fewest rows a projection runs on (``linear``).  On an H100, every
#: call of 227 rows or more gives a row of each serving shape the same bits,
#: and fewer rows may not (zamba2's 8192 -> 2048 MLP down projection splits
#: three ways below 227 rows; ``chip_smoke.py --gemm-probe`` shows it per
#: shape)
ROW_FLOOR = 256
#: the fewest rows a norm runs on: from 16 rows on, the row reductions of
#: the serving widths give a row the same bits (a norm of fewer rows splits
#: a row over more threads), and a norm of 256 rows costs ~4x a norm of 16
#: (``--gemm-probe``)
NORM_ROW_FLOOR = 16
#: (in, out) -> the fewest rows of a projection of that shape, where
#: ``ROW_FLOOR`` is not enough: on an H100 these split a row's bits at 256
#: rows and agree from 300 (seamless' and gemma3's MLP down projections) or
#: 512 (command-r-plus' K/V projections) on; ``--gemm-probe`` shows it
ROW_FLOORS = {(8192, 1024): 512, (21504, 5376): 512, (12288, 1024): 512}


def row_floor(k_in: int, n_out: int) -> int:
    """The fewest rows ``linear`` gives a projection of ``(k_in, n_out)``."""
    return ROW_FLOORS.get((k_in, n_out), ROW_FLOOR)


def cdt(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def per_row(fn, x, floor: int):
    """``fn(x)`` for a function that maps each row of ``x`` (its last dim)
    on its own, run on at least ``floor`` rows: the rows are flattened, zero
    rows appended up to the floor, and the extra rows' results dropped.  A
    row's result then does not depend on how many rows the call had."""
    lead = x.shape[:-1]
    rows = x.reshape(-1, x.shape[-1])
    m = rows.shape[0]
    if m < floor:
        rows = F.pad(rows, (0, 0, 0, floor - m))      # one kernel
    out = fn(rows)[:m]
    return out.reshape(lead + out.shape[-1:])


def linear(x, w):
    """The projection ``x @ w`` (``w`` is ``(in, out)``) on at least
    ``row_floor`` rows."""
    return per_row(lambda r: r @ w, x, row_floor(*w.shape))


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _normal_(p: torch.Tensor, scale: float, generator: torch.Generator):
    """Fill ``p`` with N(0, scale^2) drawn in f32 (the scales of the JAX
    ``_normal`` init; not its numbers)."""
    p.copy_(torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=p.device) * scale)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    def __init__(self, cfg, d: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device),
                                  requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(d, device=device),
                                  requires_grad=False)
                     if cfg.norm == "layernorm" else None)


def norm_axes(cfg):
    ax = {"scale": ("embed",)}
    if cfg.norm == "layernorm":
        ax["bias"] = ("embed",)
    return ax


def apply_norm(p: Norm, x, cfg):
    """The block's norm in f32, on at least ``NORM_ROW_FLOOR`` rows."""
    def norm(xf):
        if cfg.norm == "layernorm":
            mu = xf.mean(dim=-1, keepdim=True)
            var = xf.var(dim=-1, keepdim=True, unbiased=False)
            out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
            return out * p.scale.float() + p.bias.float()
        ms = xf.square().mean(dim=-1, keepdim=True)
        return xf * torch.rsqrt(ms + cfg.norm_eps) * p.scale.float()
    return per_row(norm, x.float(), NORM_ROW_FLOOR).to(x.dtype)


def _rms_headdim(x, eps=1e-6):
    """qk-norm: rmsnorm over the head dim (no learned scale)."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float, rotary_frac: float = 1.0):
    """x: (B, H, S, Dh); positions: (B, S) int32.  Half-split convention,
    rotating the first ``int(Dh * rotary_frac)`` (even) dims."""
    dh = x.shape[-1]
    rd = int(dh * rotary_frac)
    rd -= rd % 2
    if rd == 0:
        return x
    half = rd // 2
    # a Python-scalar base: a device tensor made from it would be a blocking
    # host-to-device copy on every call
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None, :, None] * freqs       # (B,1,S,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., :half].float()
    x2 = x[..., half:rd].float()
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot.to(x.dtype), x[..., rd:]], dim=-1)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        v, d = cfg.padded_vocab, cfg.d_model
        self.tok = _param((v, d), cdt(cfg), device)
        self.unembed = (None if cfg.tie_embeddings
                        else _param((d, v), cdt(cfg), device))

    def reset(self, cfg, generator):
        _normal_(self.tok, cfg.d_model ** -0.5, generator)
        if self.unembed is not None:
            _normal_(self.unembed, cfg.d_model ** -0.5, generator)


def embed_axes(cfg):
    ax = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        ax["unembed"] = ("embed", "vocab")
    return ax


def _embed_cut(tok, ids):
    """Rows ``ids`` of a table cut into vocab blocks over the model axis:
    each rank looks up the rows it owns (zeros elsewhere), the blocks are
    gathered, and each position takes its owner's row.  Exact: the row is
    the owner's bits (a sum over the ranks would be exact too but for a
    -0.0 entry, which + 0.0 turns into +0.0)."""
    n = tok.shape[0]
    own = ids - SH.active_mesh().coords["model"] * n
    mine = (own >= 0) & (own < n)
    rows = F.embedding(torch.where(mine, own, 0), tok)
    rows = rows * mine[..., None].to(rows.dtype)
    blocks = SH.gather(rows.unsqueeze(0), 0)          # (M,) + ids + (d,)
    owner = (ids // n).clamp(0, blocks.shape[0] - 1).long()
    return blocks.gather(0, owner[None, ..., None].expand(
        (1,) + rows.shape))[0]


def embed(p: Embed, ids, cfg):
    # the gather of index_select, with a backward that sums each row's
    # gradients in a fixed order (index_select's adds them by atomics)
    x = (F.embedding(ids, p.tok) if p.tok.shape[0] == cfg.padded_vocab
         else _embed_cut(p.tok, ids)).to(cdt(cfg))
    if cfg.embed_scale:
        # a 0-d host tensor: rounded to the compute dtype as in JAX, and
        # passed to the kernel as a scalar (no host-to-device copy)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt(cfg))
    return x


def unembed(p: Embed, x, cfg):
    w = (p.tok.t() if cfg.tie_embeddings else p.unembed).to(cdt(cfg))
    xc = x.to(cdt(cfg))
    if w.shape[-1] != cfg.padded_vocab:
        xc = SH.to_model(xc)                          # column-parallel: f
    logits = linear(xc, w)
    if logits.shape[-1] != cfg.padded_vocab:
        # vocab-cut columns: sampling reads the whole row
        logits = SH.gather(logits, -1)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = (torch.tanh(logits.float() / c) * c).to(cdt(cfg))
    if cfg.padded_vocab != cfg.vocab_size:
        # padded slots are dead: mask so samplers never pick them
        lane = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = logits.masked_fill(lane >= cfg.vocab_size, -1e30)
    return logits


# ---------------------------------------------------------------------------
# mlp
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg, device, d_ff=None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        dt = cdt(cfg)
        self.d_ff = f               # the whole width: a cut w_down is smaller
        self.w_gate = (_param((d, f), dt, device)
                       if cfg.activation in ("swiglu", "geglu") else None)
        self.w_up = _param((d, f), dt, device)
        self.w_down = _param((f, d), dt, device)
        self.b_up = _param((f,), dt, device) if cfg.use_bias else None
        self.b_down = _param((d,), dt, device) if cfg.use_bias else None

    def reset(self, cfg, generator):
        d, f = self.w_up.shape
        if self.w_gate is not None:
            _normal_(self.w_gate, d ** -0.5, generator)
        _normal_(self.w_up, d ** -0.5, generator)
        _normal_(self.w_down, f ** -0.5, generator)
        for b in (self.b_up, self.b_down):
            if b is not None:
                b.zero_()


def mlp_axes(cfg, d_ff=None):
    # w_down's ff dim feeds the down-proj contraction ("mlp_in", see wo)
    ax = {"w_down": ("mlp_in", "embed")}
    if cfg.activation in ("swiglu", "geglu"):
        ax["w_gate"] = ("embed", "mlp")
        ax["w_up"] = ("embed", "mlp")
    else:
        ax["w_up"] = ("embed", "mlp")
    if cfg.use_bias:
        ax["b_up"] = ("mlp",)
        ax["b_down"] = ("embed",)
    return ax


def mlp(p: MLP, x, cfg):
    xc = x.to(cdt(cfg))
    if p.w_up.shape[1] != p.d_ff:
        xc = SH.to_model(xc)                          # column-parallel: f
    up = linear(xc, p.w_up)
    if cfg.use_bias:
        up = up + p.b_up
    if cfg.activation == "swiglu":
        up = F.silu(linear(xc, p.w_gate)) * up
    elif cfg.activation == "geglu":
        up = F.gelu(linear(xc, p.w_gate), approximate="tanh") * up
    else:
        up = F.gelu(up, approximate="tanh")
    if up.shape[-1] != p.w_down.shape[0]:
        # the down-proj input: gathered so the contraction runs whole
        up = SH.constrain(up, -1, "act_mlp_in")
    out = linear(up, p.w_down)
    if p.w_down.shape[0] != p.d_ff:
        out = SH.from_model(out)                      # row-parallel: g
    if cfg.use_bias:
        out = out + p.b_down
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (self / cross, cached / uncached, local / global)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        qo, kvo = cfg.n_heads * hd, cfg.n_kv_heads * hd
        dt = cdt(cfg)
        self.wq = _param((d, qo), dt, device)
        self.wk = _param((d, kvo), dt, device)
        self.wv = _param((d, kvo), dt, device)
        self.wo = _param((qo, d), dt, device)
        if cfg.use_bias:
            self.bq = _param((qo,), dt, device)
            self.bk = _param((kvo,), dt, device)
            self.bv = _param((kvo,), dt, device)
            self.bo = _param((d,), dt, device)

    def reset(self, cfg, generator):
        d, qo = self.wq.shape
        for w in (self.wq, self.wk, self.wv):
            _normal_(w, d ** -0.5, generator)
        _normal_(self.wo, qo ** -0.5, generator)
        if cfg.use_bias:
            for b in (self.bq, self.bk, self.bv, self.bo):
                b.zero_()


def attn_axes(cfg):
    # wo's first dim feeds the out-proj CONTRACTION: it gets its own logical
    # name so serving can replicate it (a contraction split psums partial
    # dots, which reassociates the f32 sum — bitwise-identical serving
    # gathers the merged heads and runs the full dot instead)
    ax = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
          "wv": ("embed", "kv_heads"), "wo": ("heads_in", "embed")}
    if cfg.use_bias:
        ax.update({"bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",),
                   "bo": ("embed",)})
    return ax


def _split_heads(t, n_heads, hd):
    b, s, _ = t.shape
    return t.reshape(b, s, n_heads, hd).transpose(1, 2)


def _merge_heads(t):
    b, h, s, hd = t.shape
    return t.transpose(1, 2).reshape(b, s, h * hd)


def split_heads(t, hd):
    """(B, S, H * hd) -> (B, H, S, hd), the head count from the width: a
    rank of a mesh holds whole heads."""
    return _split_heads(t, t.shape[-1] // hd, hd)


def out_proj(p: "Attention", out, cfg):
    """The attention output (B, H, S, hd) through ``wo`` (no bias): the
    merged heads, gathered whole over the model axis when this rank holds a
    block of them and ``wo`` is whole (serving), so the contraction runs
    whole; with ``wo``'s rows cut too (training), a partial product summed
    over the model axis."""
    merged = _merge_heads(out).to(cdt(cfg))
    if merged.shape[-1] != p.wo.shape[0]:
        merged = SH.constrain(merged, -1, "act_attn_in")
    y = linear(merged, p.wo)
    if p.wo.shape[0] != cfg.n_heads * cfg.resolved_head_dim:
        y = SH.from_model(y)                          # row-parallel: g
    return y


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos):
    """Write (B, Hkv, Snew, Dh) at per-row offsets ``pos`` (B,) into the
    (B, Hkv, Smax, Dh) caches, IN PLACE.  Like JAX's dynamic_update_slice the
    start clamps to [0, Smax - Snew], so a row whose position ran past the
    end rewrites the cache's tail instead of raising."""
    b, hkv, snew, dh = k_new.shape
    start = pos.to(torch.int64).clamp(0, k_cache.shape[2] - snew)
    idx = (start[:, None] + torch.arange(snew, device=pos.device)[None, :])
    idx = idx[:, None, :, None].expand(b, hkv, snew, dh)
    k_cache.scatter_(2, idx, k_new.to(k_cache.dtype))
    v_cache.scatter_(2, idx, v_new.to(v_cache.dtype))
    return k_cache, v_cache


def store_rows(page_ids, off, *rows):
    """The rows a decode step stores into its page pools, from every lane
    of the call: each rank computed its block of the lanes, and every rank
    of the batch axes holds the whole pool, so the page ids, offsets and
    rows are gathered over "batch" (in rank order: the lanes' order) before
    the store."""
    ids = SH.gather(torch.stack([page_ids.to(torch.int64),
                                 off.to(torch.int64)]), 1, "batch")
    return (ids[0], ids[1]) + tuple(SH.gather(r, 0, "batch") for r in rows)


def layer_cache(cache: dict, prefix: str, i):
    """Slot ``i`` (an int, or a tuple over several lead axes) of the K/V
    stack ``prefix + "k"``/``prefix + "v"`` of a cache dict, as
    ``attention`` takes it: views of the dense cache, or the
    paged 3-tuple with the page table, or the quantized 5-tuple with the
    scale pools — views, so the layer's in-place K/V write reaches the
    cache."""
    if "page_table" not in cache:
        return (cache[prefix + "k"][i], cache[prefix + "v"][i])
    kv = (cache[prefix + "k_pages"][i], cache[prefix + "v_pages"][i],
          cache["page_table"])
    if prefix + "k_pages_scale" in cache:
        kv += (cache[prefix + "k_pages_scale"][i],
               cache[prefix + "v_pages_scale"][i])
    return kv


def attention(p: Attention, x, positions, cfg, *, kv_x=None, causal=True,
              window=None, kv_lens=None, q_offset=None, cache=None,
              cache_pos=None, use_rope=True, decode=False):
    """Returns (out, new_cache_kv_or_None).

    - ``kv_x``: cross-attention source (image or encoder memory, (B, Skv,
      d)): K/V are projected from it, and no rope is applied.
    - ``cache``: dense ``(k_cache, v_cache)`` of shape (B, Hkv, Smax, Dh), or
      the paged ``(k_pool, v_pool, page_table)`` of a decode step (Snew ==
      1), or the QUANTIZED paged ``(k_pool, v_pool, page_table, k_scale,
      v_scale)`` with int8/fp8 pools and (P, Hkv, ps) f32 scale pools.  New
      K/V are written IN PLACE at ``cache_pos`` (B,) — into the lane's row of
      the dense cache, or scatter-stored into its tail page (truncated to
      the narrow type first, so the token attends to its own quantized K/V)
      — and attention runs over the cache.
    - ``window``: None | int | 0-d tensor (sliding window; 2**30 = global).
    - ``decode``: a decode step rather than a prefill or a chunk of one (the
      flash kernels pick their body by it).
    """
    hd = cfg.resolved_head_dim
    xc = x.to(cdt(cfg))
    src = None if kv_x is None else kv_x.to(cdt(cfg))
    if p.wq.shape[1] != cfg.n_heads * hd:             # column-parallel: f
        xc = SH.to_model(xc)
        src = None if src is None else SH.to_model(src)
    src = xc if src is None else src
    q, k, v = linear(xc, p.wq), linear(src, p.wk), linear(src, p.wv)
    if cfg.use_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q, k, v = split_heads(q, hd), split_heads(k, hd), split_heads(v, hd)
    if cfg.qk_norm:
        q, k = _rms_headdim(q), _rms_headdim(k)
    if use_rope and kv_x is None:
        q = rope(q, positions, cfg.rope_theta, cfg.partial_rotary_factor)
        k = rope(k, positions, cfg.rope_theta, cfg.partial_rotary_factor)

    new_cache = None
    page_table = k_sc = v_sc = None
    if cache is not None:
        if len(cache) in (3, 5):
            # paged: scatter-store the new token into the lane's tail page;
            # attention reads K/V through the page table.  The page column
            # clips as in JAX, so a position past the table reuses its last
            # page.  The 5-tuple truncates on store and widens in the gather
            k_pool, v_pool, page_table = cache[:3]
            ps = k_pool.shape[2]
            page_col = (cache_pos // ps).clamp(0, page_table.shape[1] - 1)
            page_ids = page_table.gather(1, page_col[:, None].long())[:, 0]
            off = cache_pos % ps
            k_new, v_new = k[:, :, 0, :], v[:, :, 0, :]
            if SH.lanes_are_cut():
                # every batch rank holds the whole pool: store every lane
                page_ids, off, k_new, v_new = store_rows(page_ids, off,
                                                         k_new, v_new)
            if len(cache) == 5:
                k_sc, v_sc = cache[3], cache[4]
                PG.scatter_page_q(k_pool, k_sc, page_ids, off, k_new)
                PG.scatter_page_q(v_pool, v_sc, page_ids, off, v_new)
                k, v = k_pool, v_pool
                new_cache = (k_pool, v_pool, k_sc, v_sc)
            else:
                PG.scatter_page(k_pool, page_ids, off, k_new)
                PG.scatter_page(v_pool, page_ids, off, v_new)
                k, v = k_pool.to(cdt(cfg)), v_pool.to(cdt(cfg))
                new_cache = (k_pool, v_pool)
        elif len(cache) == 2:
            k_cache, v_cache = update_kv_cache(cache[0], cache[1], k, v,
                                               cache_pos)
            k, v = k_cache.to(cdt(cfg)), v_cache.to(cdt(cfg))
            new_cache = (k_cache, v_cache)
        else:
            raise ValueError(f"a cache is a 2-, 3- or 5-tuple, got {len(cache)}")

    out = flash_attention(q, k, v, kv_lens=kv_lens, causal=causal,
                          window=window, q_offset=q_offset,
                          impl=cfg.attn_impl, page_table=page_table,
                          k_scale=k_sc, v_scale=v_sc, decode=decode)
    out = out_proj(p, out, cfg)
    if cfg.use_bias:
        out = out + p.bo
    return out.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# transformer block (pre-norm / cohere-parallel), dense MLP
# ---------------------------------------------------------------------------

class Block(nn.Module):
    def __init__(self, cfg, device, d_ff=None):
        super().__init__()
        self.ln1 = Norm(cfg, cfg.d_model, device)
        self.attn = Attention(cfg, device)
        self.mlp = MLP(cfg, device, d_ff)
        self.ln2 = None if cfg.parallel_block else Norm(cfg, cfg.d_model, device)

    def reset(self, cfg, generator):
        self.attn.reset(cfg, generator)
        self.mlp.reset(cfg, generator)


def block_axes(cfg, d_ff=None):
    ax = {"ln1": norm_axes(cfg), "attn": attn_axes(cfg),
          "mlp": mlp_axes(cfg, d_ff)}
    if not cfg.parallel_block:
        ax["ln2"] = norm_axes(cfg)
    return ax


def stack_axes(axes_one):
    """``axes_one`` with a leading stacked "layers" axis on every leaf."""
    if isinstance(axes_one, dict):
        return {k: stack_axes(v) for k, v in axes_one.items()}
    return ("layers",) + tuple(axes_one)


def block_apply(p: Block, x, positions, cfg, *, causal=True, window=None,
                kv_lens=None, q_offset=None, cache=None, cache_pos=None,
                kv_x=None, use_rope=True, decode=False):
    h = apply_norm(p.ln1, x, cfg)
    attn_out, new_cache = attention(
        p.attn, h, positions, cfg, kv_x=kv_x, causal=causal, window=window,
        kv_lens=kv_lens, q_offset=q_offset, cache=cache, cache_pos=cache_pos,
        use_rope=use_rope, decode=decode)
    if cfg.parallel_block:                      # cohere: one norm, two branches
        out = x + attn_out + mlp(p.mlp, h, cfg)
    else:
        h2 = x + attn_out
        out = h2 + mlp(p.mlp, apply_norm(p.ln2, h2, cfg), cfg)
    return out, new_cache


# ---------------------------------------------------------------------------
# activation checkpointing (training)
# ---------------------------------------------------------------------------

def train_positions(tokens):
    """(B, S) int32 positions 0..S-1 of a training batch."""
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32,
                        device=tokens.device)[None].expand(b, s)


#: the matmuls whose outputs ``remat="dots"`` keeps (JAX's checkpoint_dots)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(fn, cfg):
    """Activation checkpointing of a layer body, as ``repro.models.layers.
    remat_wrap``: ``cfg.remat`` "none" runs ``fn`` as is; "full" keeps only
    the body's inputs and re-runs it in the backward
    (``torch.utils.checkpoint``, non-reentrant); "dots" also keeps the
    outputs of its matmuls (a selective checkpoint).  Outside grad mode
    (serving) ``fn`` always runs as is."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat must be none, full or dots, got {cfg.remat!r}")
    extra = ({} if cfg.remat == "full" else dict(context_fn=functools.partial(
        _ckpt.create_selective_checkpoint_contexts, _dots_policy)))

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        if not torch.is_grad_enabled():
            return fn(*args, **kw)
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, **extra, **kw)
    return wrapped
