"""Batched serving engine: prefill, a gated decode burst over request lanes,
the scheduler's page and lane movers and the fused serve step, mirroring
``ServeEngine`` of ``repro.serve.engine`` (its mesh variants belong to a
later slice).

A batch of requests is a VECTOR (paper §2.3.4): each lane is one request.
The JAX engine runs a decode burst as one XLA while loop.  Here a burst is
a static body of exactly ``n_steps`` steps with no host sync: a step is
*live* when some lane is active as it starts (``p.any()`` on the device),
and a step that is not live leaves every carry as it was — the token, the
positions, the SSM conv taps and state, the sampler keys — as the while
loop would not have run it.  Within a live step, lanes that left the active
partition have their token forced to the stop token (merging predication)
and their output slots write-masked, and their cache rows become
garbage-beyond-pos; K/V a gated step writes lands at the frozen position,
past the lane's valid length (the same contract).

On the card the burst is captured as one CUDA graph per shape bucket
(``BurstGraph``): a burst of K steps costs one replay, and ``generate``
makes one host sync per burst.  On the CPU the same body runs eagerly.

Sampling is per lane (``repro_torch.sample``): each lane carries its own
SamplingParams row and threefry key, greedy and stochastic lanes decode in
one batch, and an all-greedy batch takes the plain argmax path.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional, Sequence

import torch

from repro_torch import kernels as KN
from repro_torch import sample as S
from repro_torch.core import paging as PG
from repro_torch.core import predicate as P
from repro_torch.core.device import resolve_device
from repro_torch.models import (gather_lanes, get_model, is_paged,
                                merge_lanes, paged_decode_ok, paged_view,
                                paged_writeback, slot_update, to_paged)
from repro_torch.obs import Obs
from repro_torch.sample.processors import ban_pred, mask_logits

#: steps per decode burst of ``generate``: the JAX scheduler's default chunk
BURST = 8


@dataclasses.dataclass
class BurstGraph:
    """One captured decode burst: the CUDA graph, the static carry it reads
    and writes back (``static``, flattened by ``_flatten``, plus
    ``"steps"``: the engine's carry, which every graph of its shapes
    shares), the kernel launches of one replay (``counts``, a
    ``kernels.counts_since``), the seconds its capture took (the warm-up
    burst included) and the bytes its private memory pool reserved; ``kw``
    holds the burst's static arguments."""
    graph: object
    static: dict
    kw: dict
    counts: dict
    capture_s: float
    pool_bytes: int


def _flatten(cache, out_buf, tok, p, n_gen, lane_budget, sstate) -> dict:
    """A burst's carry as one flat dict of tensors."""
    flat = {f"cache.{k}": v for k, v in cache.items()}
    flat.update(out_buf=out_buf, tok=tok, p=p, n_gen=n_gen,
                lane_budget=lane_budget)
    flat.update({f"sstate.{k}": v for k, v in sstate.items()})
    return flat


def _shapes(flat: dict) -> tuple:
    """Every carry's shape and dtype: lanes, max_len or pages and pool size,
    page dtype, the cross K/V's length (encdec's ``src_len``, the vlm's
    image tokens), sampler state."""
    return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                        for k, v in flat.items()))


def _unflatten(flat: dict):
    """(cache, out_buf, tok, p, n_gen, sstate, steps) of a graph's carry."""
    cache = {k[6:]: v for k, v in flat.items() if k.startswith("cache.")}
    sstate = {k[7:]: v for k, v in flat.items() if k.startswith("sstate.")}
    return (cache, flat["out_buf"], flat["tok"], flat["p"], flat["n_gen"],
            sstate, flat["steps"])


@dataclasses.dataclass
class ServeEngine:
    """Generation engine over one model config + weights: the family's
    model (``DenseLM``, ``MoELM``, ``SSMLM``, ``HybridLM`` or
    ``EncDecLM``), whose ``device`` says where the weights live.

    ``device`` defaults to the card and raises if it is absent; pass
    ``device="cpu"`` to run on the CPU.  The weights must already live on
    that device.  Entry points: ``generate`` (a static batch), and the
    scheduler's ``make_paged_cache`` / ``_fused_step`` and the movers.
    """

    cfg: object
    params: object
    max_new_tokens: int = 32
    stop_token: int = 0
    # engine-wide default sampling spec for batches that carry none (None =
    # greedy argmax)
    default_sampling: Optional[S.SamplingParams] = None
    # constrained decoding: token ids masked out of EVERY lane's vocab
    # partition (greedy lanes included) before sampling
    banned_tokens: Optional[Sequence[int]] = None
    # paged decode: "native" reads K/V through the page table inside flash
    # attention; "gather" is the reference oracle: materialize the dense
    # view, run the dense decode, scatter the one new token back
    paged_attn: str = "native"
    # quantized KV pages: None (full precision) or "int8" / "fp8" — pools
    # store narrow elements with per-slot absmax scale pools alongside
    # (``<key>_pages_scale``), widened where attention reads them.  Applies
    # to every paged cache this engine allocates or converts
    page_dtype: Optional[str] = None
    device: object = None
    # observability handle (repro_torch.obs.Obs): ``generate`` records its
    # prefill/decode seams here.  The scheduler does NOT inherit it — it
    # defaults to its own registry; pass the same handle to both for one
    # combined timeline (the launcher's --trace-out does)
    obs: Optional[object] = None

    def __post_init__(self):
        if self.obs is None:
            self.obs = Obs()
        self.device = resolve_device(self.device)
        if self.paged_attn not in ("native", "gather"):
            raise ValueError(f"paged_attn must be 'native' or 'gather', "
                             f"got {self.paged_attn!r}")
        PG.resolve_page_dtype(self.page_dtype)       # validate eagerly
        self.model = get_model(self.cfg)
        # logits run over the PADDED vocab (the model already predicates the
        # pad lanes to -1e30, so leaving them "allowed" here is inert)
        v = self._vocab = getattr(self.cfg, "padded_vocab", self.cfg.vocab_size)
        self._ban = (ban_pred(v, tuple(self.banned_tokens), device=self.device)
                     if self.banned_tokens else None)
        dev = self.params.device
        if dev.type != self.device.type or (
                self.device.index is not None and dev.index != self.device.index):
            raise ValueError(f"weights live on {dev}, engine device is "
                             f"{self.device}")
        # the card's captured bursts of the current carry shapes, by their
        # static arguments, and the static carry they share
        self.graphs: dict = {}
        self._carry: Optional[dict] = None
        self._carry_shapes: Optional[tuple] = None

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------

    def _src_kw(self, batch, src_len) -> dict:
        """encdec sizes its cross-attention memory from ``batch["src_emb"]``
        or an explicit ``src_len`` (the scheduler's batch-free
        allocations); the other families take no such argument."""
        if self.cfg.family != "encdec":
            return {}
        return {"src_len": src_len if src_len is not None
                else batch["src_emb"].shape[1]}

    def make_cache(self, b: int, max_len: int, batch: Optional[dict] = None,
                   src_len: Optional[int] = None):
        """Allocate a dense cache for ``b`` request lanes."""
        return self.model.make_cache(self.cfg, b, max_len,
                                     **self._src_kw(batch, src_len),
                                     device=self.device)

    def make_paged_cache(self, b: int, max_len: int, *, page_size: int,
                         pool_pages: int, batch: Optional[dict] = None,
                         src_len: Optional[int] = None):
        """Allocate a paged cache: shared page pools + per-lane page table
        (narrow pools + scale pools when the engine has a ``page_dtype``)."""
        return self.model.make_paged_cache(self.cfg, b, max_len,
                                           **self._src_kw(batch, src_len),
                                           page_size=page_size,
                                           pool_pages=pool_pages,
                                           page_dtype=self.page_dtype,
                                           device=self.device)

    def _on_device(self, x):
        """A host-assembled input (numpy leaves, nested dicts) as tensors on
        the engine's device."""
        if isinstance(x, dict):
            return {k: self._on_device(v) for k, v in x.items()}
        return torch.as_tensor(x, device=self.device)

    @torch.inference_mode()
    def _prefill(self, params, batch, cache):
        """One prefill call (the scheduler's unfused loop): ``batch`` may
        hold host arrays.  Returns (last-token logits, cache)."""
        return self.model.prefill(params, self.cfg, self._on_device(batch),
                                  cache)

    # ------------------------------------------------------------------
    # the decode burst
    # ------------------------------------------------------------------

    def _sample(self, logits, sstate=None, out_buf=None, n_gen=None):
        """One token per lane through ``repro_torch.sample``.  With no
        state: the greedy argmax (under the engine's bans)."""
        if sstate is None:
            return S.greedy_tokens(logits if self._ban is None else
                                   mask_logits(logits, self._ban[None, :]))
        return S.sample(logits, sstate, out_tokens=out_buf, n_out=n_gen,
                        ban=self._ban)

    def make_state(self, b: int, sampling=None) -> dict:
        """Batched sampler lane state for ``b`` lanes on the engine's device
        (falls back to the engine's ``default_sampling``, then to greedy)."""
        if isinstance(sampling, dict):
            return sampling
        return S.lane_state(self.default_sampling if sampling is None
                            else sampling, b, device=self.device)

    @torch.inference_mode()
    def _decode_chunk(self, cache, out_buf, tok, p, n_gen, lane_budget,
                      sstate, *, n_steps: int, stochastic: bool = True,
                      width: Optional[int] = None):
        """A decode burst of exactly ``n_steps`` gated steps (``_burst``),
        narrowed to the first ``width`` lanes when given.  On the card it
        replays the bucket's CUDA graph, captured at its first call; on the
        CPU it runs the same body eagerly.  Returns (cache, out_buf, tok, p,
        n_gen, sstate, steps_run), ``steps_run`` the live steps as a 0-d
        int32 on the device.  On the card the returned tensors are the
        engine's static carry: its next burst of the same shapes reads them
        in place and overwrites them."""
        kw = dict(n_steps=n_steps, stochastic=stochastic, width=width)
        if self.device.type != "cuda":
            return self._burst(cache, out_buf, tok, p, n_gen, lane_budget,
                               sstate, **kw)
        flat = _flatten(cache, out_buf, tok, p, n_gen, lane_budget, sstate)
        shapes = _shapes(flat)
        if shapes != self._carry_shapes:
            self._new_carry(flat, shapes)
        key = (n_steps, stochastic, width)
        g = self.graphs.get(key)
        if g is None:
            # the warm-up burst runs on the carry: keep the inputs that are
            # the carry's own tensors
            flat = {k: v.clone() if v.data_ptr() == self._carry[k].data_ptr()
                    else v for k, v in flat.items()}
            g = self.graphs[key] = self._capture(kw)
        for k, v in flat.items():
            s = self._carry[k]
            if v.data_ptr() != s.data_ptr() or v.stride() != s.stride():
                s.copy_(v)
        g.graph.replay()
        KN.add_counts(g.counts)
        return _unflatten(self._carry)

    def _new_carry(self, flat: dict, shapes: tuple) -> None:
        """A static carry for new shapes (a bucket is the carry's shapes and
        the burst's static arguments).  The graphs of the old shapes go with
        the old carry: an engine holds one carry, whose K/V is the size of
        the cache, and the graphs' pools of one shape."""
        self.graphs.clear()
        self._carry = None
        gc.collect()
        torch.cuda.empty_cache()
        self._carry = {k: v.clone() for k, v in flat.items()}
        self._carry["steps"] = torch.zeros((), dtype=torch.int32,
                                           device=self.device)
        self._carry_shapes = shapes

    @property
    def carry_bytes(self) -> int:
        """Bytes of the static carry the card's graphs share (0 before the
        first burst and on the CPU)."""
        return sum(v.numel() * v.element_size()
                   for v in (self._carry or {}).values())

    def _capture(self, kw) -> BurstGraph:
        """Capture one burst over the engine's carry.  A warm-up burst runs
        first on the capture's side stream, so that every first-call host
        action (each library's build and load, the kernels' shared-memory
        attributes, the cuBLAS handles) happens outside the capture; its
        launches are not counted.  A capture that fails raises."""
        dev = self.device
        t0 = time.perf_counter()
        static = self._carry
        before = KN.read_counts()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._graph_body(static, kw)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        KN.set_counts(before)
        # free first what ``torch.cuda.graph`` frees on entry, so that the
        # growth of the reserved memory is the graph's own pool
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        # the captured graph is kept beside its executable, so that its
        # nodes can be read (``raw_cuda_graph``)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=side):
            self._graph_body(static, kw)
        graph.instantiate()
        torch.cuda.synchronize(dev)
        capture_s = time.perf_counter() - t0
        counts = KN.counts_since(before)
        KN.set_counts(before)
        return BurstGraph(graph, static, kw, counts, capture_s,
                          torch.cuda.memory_reserved(dev) - reserved)

    def _graph_body(self, static: dict, kw: dict) -> None:
        """The captured body: one burst over the static carry, each carry
        the burst made anew copied back into its static tensor (the K/V
        caches and pools are written in place already)."""
        cache, out_buf, tok, p, n_gen, sstate, _ = _unflatten(static)
        (cache, out_buf, tok, p, n_gen, sstate, steps) = self._burst(
            cache, out_buf, tok, p, n_gen, static["lane_budget"], sstate, **kw)
        new = _flatten(cache, out_buf, tok, p, n_gen, static["lane_budget"],
                       sstate)
        new["steps"] = steps
        for k, v in new.items():
            if v is not static[k]:
                static[k].copy_(v)

    def _burst(self, cache, out_buf, tok, p, n_gen, lane_budget, sstate, *,
               n_steps: int, stochastic: bool, width: Optional[int] = None):
        """The eager burst, optionally NARROWED to the first ``width`` lanes
        (lanes at or above it are inactive for the whole burst and pass
        through untouched, so per-lane results equal the full-width
        burst's)."""
        if width is None or width >= out_buf.shape[0]:
            return self._decode_loop(cache, out_buf, tok, p, n_gen,
                                     lane_budget, sstate, n_steps=n_steps,
                                     stochastic=stochastic)
        w = torch.arange(width, device=out_buf.device)
        (sub_cache, sub_out, sub_tok, sub_p, sub_ngen, sub_state,
         steps) = self._decode_loop(
            gather_lanes(self.cfg, cache, w), out_buf[:width], tok[:width],
            p[:width], n_gen[:width], lane_budget[:width],
            S.gather_lanes(sstate, w), n_steps=n_steps, stochastic=stochastic)
        # merge_lanes (not slot_update): a narrowed PAGED burst scatter-
        # stored its tokens into the shared pools riding sub_cache
        cache = merge_lanes(self.cfg, cache, w, sub_cache)
        sstate = S.slot_update(sstate, w, sub_state)
        join = lambda sub, full: torch.cat([sub, full[width:]])
        return (cache, join(sub_out, out_buf), join(sub_tok, tok),
                join(sub_p, p), join(sub_ngen, n_gen), sstate, steps)

    def _decode_loop(self, cache, out_buf, tok, p, n_gen, lane_budget, sstate,
                     *, n_steps: int, stochastic: bool):
        """``n_steps`` gated steps over all lanes.  A lane leaves the active
        partition ``p`` when it emits the stop token or its budget runs out.
        With ``stochastic`` every live step samples through the lane state
        (keys split once a step for every lane; penalties read each lane's
        own ``out_buf``), else it takes the argmax and leaves the state
        alone.  Returns (cache, out_buf, tok, p, n_gen, sstate, steps_run)."""
        out_buf = out_buf.clone()
        steps = torch.zeros((), dtype=torch.int32, device=out_buf.device)
        for _ in range(n_steps):
            cache, out_buf, tok, p, n_gen, sstate, live = self._step(
                cache, out_buf, tok, p, n_gen, lane_budget, sstate,
                stochastic=stochastic)
            steps = steps + live.to(torch.int32)
        return cache, out_buf, tok, p, n_gen, sstate, steps

    def _step(self, cache, out_buf, tok, p, n_gen, lane_budget, sstate, *,
              stochastic: bool):
        """One gated decode step; writes ``out_buf`` in place.  When no lane
        is active as it starts (``live`` False) every carry keeps its value:
        the new ones are selected against the old, and the SSM carries,
        written in place, are gated inside the model.  Returns the carry and
        ``live``."""
        stop = self.stop_token
        live = p.any()
        # a lane outside p may carry the stop token, which need not be a row
        # of the embedding table (e.g. -1): its results are masked, and it
        # reads the row JAX's take reads (a negative id wraps), or past
        # [-V, V) a clamped row where JAX's take fills NaN
        v = self._vocab
        feed = P.merging(p, tok,
                         torch.where(tok < 0, tok + v, tok).clamp(0, v - 1))
        logits, new = self._cached_decode({"token": feed[:, None],
                                           "live": live}, cache)
        cache = {k: v if v is cache[k] else torch.where(live, v, cache[k])
                 for k, v in new.items()}
        if stochastic:
            nxt, new_state = self._sample(logits, sstate, out_buf, n_gen)
            sstate = {k: v if v is sstate[k] else torch.where(live, v, sstate[k])
                      for k, v in new_state.items()}
        else:
            nxt = self._sample(logits)
        nxt = P.merging(p, nxt, torch.full_like(nxt, stop))
        rows = torch.arange(out_buf.shape[0], device=out_buf.device)
        col = n_gen.clamp(0, out_buf.shape[1] - 1).long()
        out_buf[rows, col] = torch.where(p, nxt, out_buf[rows, col])
        n_gen = n_gen + p.to(torch.int32)
        p = p & (nxt != stop) & (n_gen < lane_budget)
        return cache, out_buf, torch.where(live, nxt, tok), p, n_gen, sstate, live

    def _cached_decode(self, batch, cache):
        """One decode step against a dense OR paged cache (native paged, or
        the "gather" oracle: dense view through the table, unchanged decode,
        the new token scattered back; on a quantized cache the oracle
        dequantizes the same pool bytes and truncates the new token back)."""
        if not is_paged(cache):
            return self.model.decode(self.params, self.cfg, batch, cache)
        if self.paged_attn != "gather" and paged_decode_ok(self.cfg):
            return self.model.decode(self.params, self.cfg, batch, cache)
        view = paged_view(self.cfg, cache)
        pos = view["pos"]
        logits, view = self.model.decode(self.params, self.cfg, batch, view)
        return logits, paged_writeback(self.cfg, cache, view, pos)

    # ------------------------------------------------------------------
    # admission: prefix seeds, page installs, the lane splice
    # ------------------------------------------------------------------

    def _seed_pages(self, cache, sub_cache, seed_tab, seed_len, max_len: int):
        """Gather resident shared-prefix pages of the live paged ``cache``
        into a dense prefill ``sub_cache`` (positions [0, seed_len) per row),
        so suffix rows attend over the donor's K/V.  A quantized cache's
        seed widens through the scale pool."""
        spec = self.model.paged_cache_spec(self.cfg)
        seed_tab = torch.as_tensor(seed_tab, device=self.device)
        seed_len = torch.as_tensor(seed_len, device=self.device)
        m = seed_tab.shape[0]
        mask = (torch.arange(max_len, dtype=torch.int32, device=self.device)[None, :]
                < seed_len[:, None])
        sub_cache = dict(sub_cache)
        for key, lead in spec.items():
            view = PG.gather_pages(cache[key + "_pages"], seed_tab,
                                   n_lead=len(lead),
                                   scale=cache.get(key + "_pages_scale"))
            mm = mask.reshape((1,) * len(lead) + (m, 1, max_len, 1))
            sub_cache[key] = torch.where(mm, view.to(sub_cache[key].dtype),
                                         sub_cache[key])
        return sub_cache

    def _install_pages(self, cache, sub_cache, rows, cols, dsts, tab_rows,
                       lanes):
        """Scatter freshly prefilled K/V blocks ``(rows, cols)`` of the dense
        ``sub_cache`` into physical pages ``dsts`` of the live paged
        ``cache`` (IN PLACE; truncating through ``scatter_block_q`` on a
        quantized cache) and install the page-table rows at ``lanes``.
        Padding entries aim at the trash page or past the last lane, which
        drops."""
        spec = self.model.paged_cache_spec(self.cfg)
        cache = dict(cache)
        rows, cols, dsts = (torch.as_tensor(t, device=self.device).long()
                            for t in (rows, cols, dsts))
        n_pages = cache["page_table"].shape[1]
        for key, lead in spec.items():
            dn = sub_cache[key]                      # lead+(m,Hkv,S,Dh)
            nl = len(lead)
            shp = dn.shape
            ps = shp[-2] // n_pages
            dnp = dn.reshape(shp[:nl + 2] + (n_pages, ps, shp[-1]))
            dnp = torch.movedim(dnp, nl, 0)          # (m,)+lead+(Hkv,n,ps,D)
            dnp = torch.movedim(dnp, nl + 2, 1)      # (m,n_pages)+lead+...
            blocks = dnp[rows, cols]                 # (K,)+lead+(Hkv,ps,D)
            sc = cache.get(key + "_pages_scale")
            if sc is not None:                       # truncating store
                PG.scatter_block_q(cache[key + "_pages"], sc, dsts, blocks,
                                   n_lead=nl)
            else:
                PG.scatter_block(cache[key + "_pages"], dsts, blocks, n_lead=nl)
        cache["page_table"] = P.set_lanes(cache["page_table"], lanes, tab_rows)
        return cache

    def _splice_admission(self, cache, out_buf, tok, p, n_gen, budget, sstate,
                          lanes, first_tok, sub_cache, sub_state, budgets,
                          info):
        """The admission tail: page installs, cache/sampler slot_update, and
        the per-lane decode seeds.  ``lanes`` may carry out-of-range entries
        for padded rows; every splice drops them, with no host sync."""
        lanes = torch.as_tensor(lanes, device=self.device)
        budgets = torch.as_tensor(budgets, device=self.device).to(torch.int32)
        if "copy_dsts" in info:
            cache = self._install_pages(cache, sub_cache, info["copy_rows"],
                                        info["copy_cols"], info["copy_dsts"],
                                        info["tab_rows"], lanes)
        cache = slot_update(self.cfg, cache, lanes, sub_cache)
        sstate = S.slot_update(sstate, lanes, sub_state)
        tok = P.set_lanes(tok, lanes, first_tok)
        seeds = torch.zeros((lanes.shape[0], out_buf.shape[1]),
                            dtype=out_buf.dtype, device=out_buf.device)
        seeds[:, 0] = first_tok
        out_buf = P.set_lanes(out_buf, lanes, seeds)
        n_gen = P.set_lanes(n_gen, lanes, 1)
        budget = P.set_lanes(budget, lanes, budgets)
        alive = (first_tok != self.stop_token) & (budgets > 1)
        p = P.set_lanes(p, lanes, alive)
        return cache, out_buf, tok, p, n_gen, budget, sstate

    @torch.inference_mode()
    def _fused_step(self, cache, out_buf, tok, p, n_gen, budget, sstate,
                    admit, parts, *, n_steps: int, stochastic: bool,
                    admit_stoch: bool, part_final: tuple, part_stoch: tuple,
                    max_len: int, width: Optional[int] = None):
        """A whole scheduling round: the round's chunked-prefill chunk(s),
        the admission sub-batch (zero-init -> prefix seed -> prefill ->
        first-token sample -> page install -> lane splice), and an
        ``n_steps`` decode burst, in the JAX engine's order.  The prefill
        part runs eagerly; the burst is ``_decode_chunk`` (a graph replay on
        the card).

        ``admit`` is None or a dict assembled host-side (batch / lanes /
        budgets / sampler rows / page-copy plan); ``parts`` is a tuple of
        per-partial dicts (batch + accumulating sub-cache, plus splice data
        when the chunk is final).  Returns (cache, out_buf, tok, p, n_gen,
        budget, sstate, steps_run, new_caches-of-non-final-partials)."""
        new_part_caches = []
        for i, part in enumerate(parts):
            part = dict(self._on_device({k: v for k, v in part.items()
                                         if k != "cache"}),
                        cache=part["cache"])
            sub_in = part["cache"]
            if "seed_tab" in part:
                sub_in = self._seed_pages(cache, sub_in, part["seed_tab"],
                                          part["seed_len"], max_len)
            logits, sub = self.model.prefill(self.params, self.cfg,
                                             part["batch"], sub_in)
            if not part_final[i]:
                new_part_caches.append(sub)
                continue
            if part_stoch[i]:
                first, sub_state = self._sample(logits, part["sub_state"])
            else:
                first = self._sample(logits)
                sub_state = part["sub_state"]
            (cache, out_buf, tok, p, n_gen, budget,
             sstate) = self._splice_admission(
                cache, out_buf, tok, p, n_gen, budget, sstate, part["lane"],
                first, sub, sub_state, part["budget"], part)
        if admit is not None:
            admit = self._on_device(admit)
            batch = admit["batch"]
            sub_cache = self.make_cache(batch["tokens"].shape[0], max_len,
                                        batch)
            if "seed_tab" in admit:
                sub_cache = self._seed_pages(cache, sub_cache,
                                             admit["seed_tab"],
                                             admit["seed_len"], max_len)
            logits, sub_cache = self.model.prefill(self.params, self.cfg,
                                                   batch, sub_cache)
            if admit_stoch:
                first, sub_state = self._sample(logits, admit["sub_state"])
            else:
                first = self._sample(logits)
                sub_state = admit["sub_state"]
            (cache, out_buf, tok, p, n_gen, budget,
             sstate) = self._splice_admission(
                cache, out_buf, tok, p, n_gen, budget, sstate,
                admit["lanes"], first, sub_cache, sub_state,
                admit["budgets"], admit)
        cache, out_buf, tok, p, n_gen, sstate, steps = self._decode_chunk(
            cache, out_buf, tok, p, n_gen, budget, sstate, n_steps=n_steps,
            stochastic=stochastic, width=width)
        return (cache, out_buf, tok, p, n_gen, budget, sstate, steps,
                tuple(new_part_caches))

    # ------------------------------------------------------------------
    # host-swap page movers (the scheduler's eviction tier)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _gather_blocks(self, cache, pids):
        """Batched whole-page read: for each pool (and scale pool) of the
        paged ``cache``, pages ``pids (K,)`` as ``(K,) + lead + (Hkv, ps[,
        D])`` blocks — the device->host half of a spill.  A quantized cache
        spills its NARROW bytes plus scales, so a later page-in restores the
        pool rows bit for bit."""
        pids = torch.as_tensor(pids, device=self.device)
        out = {}
        for key, lead in self.model.paged_cache_spec(self.cfg).items():
            for suffix in ("_pages", "_pages_scale"):
                pk = key + suffix
                if pk in cache:
                    out[pk] = PG.gather_block(cache[pk], pids, n_lead=len(lead))
        return out

    @torch.inference_mode()
    def _scatter_blocks(self, cache, pids, blocks):
        """Batched whole-page write, IN PLACE: ``blocks`` (the dict
        ``_gather_blocks`` produced) into pages ``pids`` — the page-in half
        of a swap.  Padding entries aim at the trash page."""
        pids = torch.as_tensor(pids, device=self.device)
        cache = dict(cache)
        for key, lead in self.model.paged_cache_spec(self.cfg).items():
            for suffix in ("_pages", "_pages_scale"):
                pk = key + suffix
                if pk in cache:
                    PG.scatter_block(cache[pk], pids,
                                     torch.as_tensor(blocks[pk],
                                                     device=self.device),
                                     n_lead=len(lead))
        return cache

    # ------------------------------------------------------------------
    # preemption lane movers (the scheduler's bit-exact preempt/resume)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _spill_lane(self, cache, out_buf, tok, n_gen, budget, sstate, lane):
        """ONE lane's host-spillable state: its dense per-lane cache carries
        (every key with a declared lane axis; page pools and the page table
        move through ``_gather_blocks``), its decode rows (out_buf/tok/
        n_gen/budget) and its sampler-state row, each without the lane
        axis.  With the lane's page blocks this is the whole request state:
        splicing it back resumes the token stream bit for bit."""
        idx = torch.as_tensor(lane, device=self.device).to(torch.int64).reshape(1)
        axes = self.model.cache_batch_axes(self.cfg)
        dense = {k: v.select(axes[k], 0)
                 for k, v in gather_lanes(self.cfg, cache, idx).items()
                 if k in axes}
        row = {"out": out_buf[idx][0], "tok": tok[idx][0],
               "ngen": n_gen[idx][0], "budget": budget[idx][0]}
        srow = {k: v[0] for k, v in S.gather_lanes(sstate, idx).items()}
        return dense, row, srow

    @torch.inference_mode()
    def _resume_lane(self, cache, out_buf, tok, p, n_gen, budget, sstate,
                     lane, dense, row, srow, table_row):
        """Splice a spilled lane back: the dense carries into the lane (pool
        keys absent from ``dense`` pass through), the rebuilt page-table
        row when paged, and the decode/sampler rows exactly as spilled."""
        lane = torch.as_tensor(lane, device=self.device).to(torch.int64)
        cache = slot_update(self.cfg, cache, lane, dense)
        if table_row is not None:
            cache = dict(cache)
            cache["page_table"] = P.set_lanes(cache["page_table"], lane,
                                              table_row)
        sstate = S.slot_update(sstate, lane, srow)
        out_buf = P.set_lanes(out_buf, lane, row["out"])
        tok = P.set_lanes(tok, lane, row["tok"])
        n_gen = P.set_lanes(n_gen, lane, row["ngen"])
        budget = P.set_lanes(budget, lane, row["budget"])
        p = P.set_lanes(p, lane, True)
        return cache, out_buf, tok, p, n_gen, budget, sstate

    # ------------------------------------------------------------------
    # one-shot batch API
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def generate(self, batch, *, max_len: Optional[int] = None,
                 sampling=None, page_size: Optional[int] = None,
                 pool_pages: Optional[int] = None):
        """batch: {"tokens": (B, S) prompts, "lens": (B,)} (tensors or
        arrays), with the model's modality extras: encdec's ``src_emb``
        (B, S_src, d) and ``src_lens`` (B,), the vlm's ``cross_emb`` (B, N,
        d).

        ``sampling`` is None (the engine default, else greedy), one
        ``SamplingParams`` broadcast over lanes, a per-lane sequence of
        them, or a lane state dict.  With ``page_size`` the prefilled cache
        is converted to the PAGED layout (identity page tables; narrow pools
        with the engine's ``page_dtype``) before decoding.  Decodes in
        bursts of ``BURST`` steps (a graph replay each on the card) with one
        host sync per burst, until no lane is active.  Returns dict with
        tokens (B, max_new), n_generated (B,), the final active partition,
        and the cache (a copy of the graphs' carry on the card).
        """
        cache, out, tok, p, n_gen, budget, sstate, stochastic = self._start(
            batch, max_len=max_len, sampling=sampling, page_size=page_size,
            pool_pages=pool_pages)
        # the budgets end every lane within max_new - 1 steps
        with self.obs.span("decode", dispatch=True, b=out.shape[0],
                           n_steps=self.max_new_tokens):
            for _ in range(-(-self.max_new_tokens // BURST)):
                if not bool(p.any()):
                    break
                cache, out, tok, p, n_gen, sstate, _ = self._decode_chunk(
                    cache, out, tok, p, n_gen, budget, sstate, n_steps=BURST,
                    stochastic=stochastic)
        if self.device.type == "cuda":
            # the engine's carry, which its next burst overwrites
            cache = {k: v.clone() for k, v in cache.items()}
        return {"tokens": out.clone(), "n_generated": n_gen.clone(),
                "active": tok != self.stop_token, "cache": cache}

    @torch.inference_mode()
    def _start(self, batch, *, max_len=None, sampling=None, page_size=None,
               pool_pages=None):
        """``generate``'s state before its first burst: the prefilled cache
        (paged with ``page_size``), out_buf with the first tokens, tok, p,
        n_gen, the budgets, the sampler state, and whether any lane samples
        (decided once: all-greedy batches skip the stochastic pipeline, and
        keys of greedy lanes are never read, so not splitting them is
        inert)."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        b, s = tokens.shape
        lens = batch.get("lens")
        lens = (torch.full((b,), s, dtype=torch.int32, device=self.device)
                if lens is None
                else torch.as_tensor(lens, device=self.device).to(torch.int32))
        max_len = max_len or (s + self.max_new_tokens)
        extras = {k: self._on_device(v) for k, v in batch.items()
                  if k not in ("tokens", "lens")}
        cache = self.make_cache(b, max_len, extras)
        sstate = self.make_state(b, sampling)
        with self.obs.span("prefill", dispatch=True, b=b, s=s):
            logits, cache = self.model.prefill(
                self.params, self.cfg, dict(extras, tokens=tokens, lens=lens),
                cache)
        if page_size is not None:
            cache = to_paged(self.cfg, cache, page_size=page_size,
                             pool_pages=pool_pages, page_dtype=self.page_dtype)
        stochastic = not S.is_all_greedy(sstate)
        if stochastic:
            first_tok, sstate = self._sample(logits, sstate)
        else:
            first_tok = self._sample(logits)
        max_new = self.max_new_tokens
        out = torch.zeros((b, max_new), dtype=torch.int32, device=self.device)
        out[:, 0] = first_tok
        budget = torch.full((b,), max_new, dtype=torch.int32, device=self.device)
        p = (first_tok != self.stop_token) & (budget > 1)
        n_gen = torch.ones((b,), dtype=torch.int32, device=self.device)
        return cache, out, first_tok, p, n_gen, budget, sstate, stochastic
