"""Batched serving engine: prefill plus a predicated decode loop over request
lanes, mirroring ``ServeEngine.generate`` of ``repro.serve.engine``.

A batch of requests is a VECTOR (paper §2.3.4): each lane is one request.
The JAX engine runs the decode loop as one XLA while loop; here it is an
eager loop over at most ``n_steps`` steps with the same predicated
semantics: every lane decodes each step, lanes that left the active
partition have their token forced to the stop token (merging predication)
and their output slots write-masked, and their cache rows become
garbage-beyond-pos.  The loop stops early once no lane is live, which costs
one host sync per step.

Sampling is per lane (``repro_torch.sample``): each lane carries its own
SamplingParams row and threefry key, greedy and stochastic lanes decode in
one batch, and an all-greedy batch takes the plain argmax path.  The fused
serve step, block movers, spill/resume, meshes and obs belong to the
scheduler's slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch import sample as S
from repro_torch.core import paging as PG
from repro_torch.core import predicate as P
from repro_torch.core.device import resolve_device
from repro_torch.models import (get_model, is_paged, paged_decode_ok,
                                paged_view, paged_writeback, to_paged)
from repro_torch.sample.processors import ban_pred, mask_logits


@dataclasses.dataclass
class ServeEngine:
    """Generation engine over one model config + weights: the family's
    model (``DenseLM``, ``MoELM``, ``SSMLM`` or ``HybridLM``), whose
    ``device`` says where the weights live.

    ``device`` defaults to the card and raises if it is absent; pass
    ``device="cpu"`` to run on the CPU.  The weights must already live on
    that device.
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

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.paged_attn not in ("native", "gather"):
            raise ValueError(f"paged_attn must be 'native' or 'gather', "
                             f"got {self.paged_attn!r}")
        PG.resolve_page_dtype(self.page_dtype)       # validate eagerly
        self.model = get_model(self.cfg)
        # logits run over the PADDED vocab (the model already predicates the
        # pad lanes to -1e30, so leaving them "allowed" here is inert)
        v = getattr(self.cfg, "padded_vocab", self.cfg.vocab_size)
        self._ban = (ban_pred(v, tuple(self.banned_tokens), device=self.device)
                     if self.banned_tokens else None)
        dev = self.params.device
        if dev.type != self.device.type or (
                self.device.index is not None and dev.index != self.device.index):
            raise ValueError(f"weights live on {dev}, engine device is "
                             f"{self.device}")

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------

    def make_cache(self, b: int, max_len: int):
        """Allocate a dense cache for ``b`` request lanes."""
        return self.model.make_cache(self.cfg, b, max_len, device=self.device)

    def make_paged_cache(self, b: int, max_len: int, *, page_size: int,
                         pool_pages: int):
        """Allocate a paged cache: shared page pools + per-lane page table
        (narrow pools + scale pools when the engine has a ``page_dtype``)."""
        return self.model.make_paged_cache(self.cfg, b, max_len,
                                           page_size=page_size,
                                           pool_pages=pool_pages,
                                           page_dtype=self.page_dtype,
                                           device=self.device)

    # ------------------------------------------------------------------
    # decode loop
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

    def _decode_loop(self, cache, out_buf, tok, p, n_gen, lane_budget, sstate,
                     *, n_steps: int, stochastic: bool):
        """At most ``n_steps`` decode steps over all lanes.  A lane leaves the
        active partition ``p`` when it emits the stop token or its budget
        runs out.  ``out_buf`` is written in place.  With ``stochastic``
        every step samples through the lane state (keys split once a step
        for every lane; penalties read each lane's own ``out_buf``), else it
        takes the argmax and leaves the state alone.  Returns (cache,
        out_buf, tok, p, n_gen, sstate, steps_run)."""
        stop = self.stop_token
        b, max_out = out_buf.shape
        rows = torch.arange(b, device=out_buf.device)
        step = 0
        while step < n_steps and bool(p.any()):
            logits, cache = self._cached_decode({"token": tok[:, None]}, cache)
            if stochastic:
                nxt, sstate = self._sample(logits, sstate, out_buf, n_gen)
            else:
                nxt = self._sample(logits)
            nxt = P.merging(p, nxt, torch.full_like(nxt, stop))
            col = n_gen.clamp(0, max_out - 1).long()
            out_buf[rows, col] = torch.where(p, nxt, out_buf[rows, col])
            n_gen = n_gen + p.to(torch.int32)
            p = p & (nxt != stop) & (n_gen < lane_budget)
            tok = nxt
            step += 1
        return cache, out_buf, tok, p, n_gen, sstate, step

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
    # one-shot batch API
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def generate(self, batch, *, max_len: Optional[int] = None,
                 sampling=None, page_size: Optional[int] = None,
                 pool_pages: Optional[int] = None):
        """batch: {"tokens": (B, S) prompts, "lens": (B,)} (tensors or
        arrays).

        ``sampling`` is None (the engine default, else greedy), one
        ``SamplingParams`` broadcast over lanes, a per-lane sequence of
        them, or a lane state dict.  With ``page_size`` the prefilled cache
        is converted to the PAGED layout (identity page tables; narrow pools
        with the engine's ``page_dtype``) before the decode loop.  Returns
        dict with tokens (B, max_new), n_generated (B,), the final active
        partition, and the cache.
        """
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        b, s = tokens.shape
        lens = batch.get("lens")
        lens = (torch.full((b,), s, dtype=torch.int32, device=self.device)
                if lens is None
                else torch.as_tensor(lens, device=self.device).to(torch.int32))
        max_len = max_len or (s + self.max_new_tokens)
        cache = self.make_cache(b, max_len)
        sstate = self.make_state(b, sampling)
        logits, cache = self.model.prefill(
            self.params, self.cfg, {"tokens": tokens, "lens": lens}, cache)
        if page_size is not None:
            cache = to_paged(self.cfg, cache, page_size=page_size,
                             pool_pages=pool_pages, page_dtype=self.page_dtype)
        # all-greedy batches skip the stochastic pipeline (keys of greedy
        # lanes are never read, so not splitting them is inert)
        stochastic = not S.is_all_greedy(sstate)
        if stochastic:
            first_tok, sstate = self._sample(logits, sstate)
        else:
            first_tok = self._sample(logits)

        max_new = self.max_new_tokens
        out = torch.zeros((b, max_new), dtype=torch.int32, device=self.device)
        out[:, 0] = first_tok
        budget = torch.full((b,), max_new, dtype=torch.int32, device=self.device)
        p0 = (first_tok != self.stop_token) & (budget > 1)
        cache, out, tok, _, n_gen, _, _ = self._decode_loop(
            cache, out, first_tok, p0,
            torch.ones((b,), dtype=torch.int32, device=self.device), budget,
            sstate, n_steps=max_new, stochastic=stochastic)
        return {"tokens": out, "n_generated": n_gen,
                "active": tok != self.stop_token, "cache": cache}
