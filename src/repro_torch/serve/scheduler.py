"""Continuous-batching scheduler: SVE compact/partition semantics for
traffic, as in ``repro.serve.scheduler``, over the port's ``ServeEngine``.

The serving batch is a vector of request LANES.  A lane's lifecycle is the
paper's §2.3.4 partition algebra applied to traffic instead of loop strips:

  * **admission** — a queued request is prefilled (as part of a sub-batch)
    and spliced into a free lane via ``repro_torch.models.slot_update``: an
    index scatter along each cache tensor's declared lane axis.
  * **decode** — the engine's ``_decode_chunk`` runs bounded bursts (one
    CUDA graph replay on the card); per-lane stop tokens / budgets shrink
    the active partition on the device.
  * **harvest** — lanes that left the partition surrender their tokens and
    become free slots.
  * **compaction** — when occupancy drops below ``compact_threshold``, the
    survivors are squeezed into the lowest-numbered lanes with the SVE
    ``compact`` permutation applied to the cache (``gather_lanes``) and
    every per-lane side table.  Lanes stay dense, so admission always
    splices into the tail and throughput is a function of ACTIVE lanes.

With ``page_size`` set the cache is PAGED (SVE §2.3.3 gather/scatter): each
lane addresses logical token blocks through a per-lane page table while the
physical pages live in a shared ref-counted pool.  Admission is then gated on
PAGE availability, and a prefix index lets a request whose prompt prefix is
already resident skip prefill for the shared pages (refcount bump + suffix
prefill).  Compacting lanes never moves a page: only the table rows permute.

With ``host_swap_pages`` set, the prefix cache grows an EVICTION TIER: a
shared-prefix page whose refcount drops to zero is spilled to a host-side
LRU store (content-addressed by its full prefix token bytes), and a later
request whose prompt walks the same prefix pages it back in — the prefix
cache becomes a cross-REQUEST session cache.  A quantized pool spills its
narrow bytes plus scales, so page-in restores the pool rows bit for bit.

The default serve path is the FUSED step (``fused=True``): one round's
prefill chunk(s), admission tail and decode burst go through one
``ServeEngine._fused_step`` call, so the host's per-round work is pure
bookkeeping, and the round's one wait for the device is its harvest
(``_block_on``).  With ``overlap=True`` the host loop goes ASYNC on top:
round N+1 is dispatched before round N's results are read back, and the
one blocking sync per round harvests the PREVIOUS round from host copies
queued right after its dispatch — admission plans against a one-round-stale
lane view, which only under-reports free lanes (a lane's tokens do not
depend on its burst's width or company, ``LANE_INDEPENDENT_DECODE``, so
results are unchanged).

The request control plane: ``cancel`` at any stage, priorities (a
page-starved higher-priority request preempts a strictly lower one: the
victim's whole state spills to the host and resumes bit for bit later),
finish and first-token deadlines (an infeasible request is shed at
admission, a resident one past its deadline retires with its partial
output), and a bounded queue (``max_queue``) that sheds on overload.
``serve.chaos`` injects faults into it.

On the card the engine's ``_decode_chunk`` returns its graphs' static carry,
which the next replay overwrites in place: the scheduler's ``cache``,
``out_buf``, ``tok``, ``p`` and ``n_gen`` ARE those tensors between rounds.
The harvest copies what it needs to the host before the next dispatch (the
overlap stash queues its copies into pinned host buffers right after its
own dispatch, so it owns its bytes), and every host-side update (harvest's
page-table repoint, compaction's gathers, the admission splices, cancel's
and preemption's lane retirement, resume) builds new tensors, which the
next burst copies into the carry.  Only the page pools are written in place
(page installs, page-in, resume's page scatter), as the captured decode
writes them.

encdec serving takes ``src_len`` and each request's encoder input as
``extras`` (``src_emb``, zero-padded to ``src_len`` at submit, and its true
length ``src_lens``).

Over a mesh (an engine with a ``mesh``: every family, KV heads, MLP
columns, experts and vocab over the model axis, lanes over the data axis)
every rank runs this scheduler on its own engine.  The page pools and
scale pools hold the rank's KV heads and every page (each data rank a
whole copy, every lane's K/V stored into it); the per-lane dense K/V,
cross K/V, conv taps and SSM states hold the rank's block of the lanes
(all of them where the data axis does not divide the capacity, or an
admission sub-batch, or a chunked prefill's one lane); the page tables,
``pos``, the allocator, the prefix index, the decode carry and the
sampler lanes are whole on every rank.  Admission, harvest, compaction,
preemption, host swap and encdec ``extras`` go through the engine's
movers (``gather_lanes``, ``slot_update``, ``_spill_lane``,
``_resume_lane``, the page movers), which gather a lane whole where it
changes rank.  Every host decision reads only replicated values — the
gathered logits' tokens, counts and steps, never a clock — so the ranks
take the same decisions and meet at every collective, with one device's
dispatches and host syncs.  The host-swap tier's CRC covers each rank's
own bytes.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import time
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch import sample as S
from repro_torch.core import paging as PG
from repro_torch.core import predicate as P
from repro_torch.models import (chunked_prefill_granularity, chunked_prefill_ok,
                                get_model, lane_independent_decode)
from repro_torch.obs import Obs

from .engine import ServeEngine

#: every scheduler stat, registered as a typed metric in the obs registry
#: (``(name, snapshot key)``; None = same).  ``stats`` is a dict view over
#: these, so ``stats["x"] += 1`` call sites keep working while
#: ``obs.metrics.snapshot()`` is the single summary definition.
_STAT_COUNTERS = (
    ("steps", "rounds"), ("decode_steps", None), ("lane_steps", None),
    ("active_lane_steps", None), ("compactions", None),
    ("prefix_hits", None), ("prefix_hit_tokens", None),
    ("prefill_tokens", None), ("page_waits", None), ("prefill_chunks", None),
    ("dispatches", None), ("host_syncs", None), ("swap_out_pages", None),
    ("swap_in_pages", None), ("session_hits", None),
    ("session_hit_tokens", None),
    # request-lifecycle robustness counters (deadlines / cancellation /
    # preemption / shedding / swap integrity)
    ("preemptions", None), ("shed", None), ("cancelled", None),
    ("deadline_misses", None), ("resume_page_ins", None),
    ("swap_checksum_failures", None),
)


class FinishReason(str, enum.Enum):
    """Why a request's result is what it is.  Every entry in ``run()``'s
    results carries one under ``"finish_reason"``; the str values are what
    lands in logs.  ``PREEMPTED_RESUMED`` marks a request that finished
    normally but was preempted (and resumed bit for bit) at least once
    along the way: its tokens equal an uninterrupted run's."""
    DONE = "done"
    CANCELLED = "cancelled"
    DEADLINE = "deadline"
    SHED = "shed"
    PREEMPTED_RESUMED = "preempted_resumed"


class RequestRejected(ValueError):
    """Typed rejection raised by ``submit`` for a request that could NEVER
    be admitted (prompt longer than the lane cache, or a worst-case page
    demand the pool cannot cover even when empty)."""


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


#: host (numpy) dtype of each tensor dtype numpy lacks: the same bits
_BITS = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
         torch.float8_e4m3fn: torch.uint8}


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor that the host already holds (bf16 and fp8 as
    their bits, so a page block's bytes are the pool's)."""
    t = t.detach()
    if t.dtype in _BITS:
        t = t.view(_BITS[t.dtype])
    return t.numpy().copy() if t.device.type == "cpu" else t.numpy()


def _to_device(a: np.ndarray, dtype, device) -> torch.Tensor:
    """The inverse of ``_to_host``: host bits as a tensor of ``dtype``."""
    t = torch.from_numpy(np.ascontiguousarray(a).reshape(np.shape(a)))
    if dtype in _BITS:
        t = t.view(dtype)
    return t.to(device)


class PageAllocator:
    """Ref-counted physical page allocator with a LIFO free list.

    Invariants: a page is either free or has refcount >= 1; ``alloc`` is
    all-or-nothing; releasing to zero returns the page to the free list
    exactly once (double release raises); free + live == pool_pages.
    """

    def __init__(self, pool_pages: int):
        self.pool_pages = pool_pages
        self._free = list(range(pool_pages - 1, -1, -1))
        self.refcount = np.zeros((pool_pages,), np.int64)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return self.pool_pages - len(self._free)

    def alloc(self, n: int):
        """n fresh pages with refcount 1, or None if the pool can't cover n."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert self.refcount[p] == 0, f"page {p} on free list with refs"
            self.refcount[p] = 1
        return pages

    def retain(self, page: int):
        """Bump the refcount of a RESIDENT page (prefix sharing)."""
        if self.refcount[page] <= 0:
            raise ValueError(f"retain of free page {page}")
        self.refcount[page] += 1

    def release(self, page: int) -> bool:
        """Drop one reference; True if the page returned to the free list."""
        if self.refcount[page] <= 0:
            raise ValueError(f"double free of page {page}")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(page)
            return True
        return False


def _entry_crc(entry: dict) -> int:
    """Content checksum of one swap-store entry (all pool blocks, key-sorted
    so the digest is layout-stable)."""
    crc = 0
    for k in sorted(entry):
        crc = zlib.crc32(np.ascontiguousarray(entry[k]).tobytes(), crc)
    return crc


class HostSwapStore:
    """Host-side LRU store of evicted prefix pages (the swap tier).

    Entries are content-addressed by the FULL prefix token bytes up to and
    including the page's block, which is sound across page-id recycling.
    Each entry holds one page's pool blocks as numpy arrays ``{pool_key:
    lead + (Hkv, ps[, D])}`` (bf16 and fp8 as their bits) — quantized pools
    store narrow bytes + scales, so page-in is exact.  Capacity is counted
    in PAGES; insertion past capacity evicts least-recently-used entries.

    Every entry carries a CRC taken at ``put`` time and verified at ``get``:
    a corrupted entry is dropped and ``get`` returns None, so the planner's
    swap-chain walk stops there and the request cold-prefills the rest —
    degraded latency, NEVER wrong tokens.
    """

    def __init__(self, max_pages: int):
        if max_pages < 1:
            raise ValueError(f"host_swap_pages must be >= 1, got {max_pages}")
        self.max_pages = max_pages
        self._store: collections.OrderedDict = collections.OrderedDict()
        self._crc: dict = {}
        self.evictions = 0
        self.checksum_failures = 0

    def __len__(self):
        return len(self._store)

    def __contains__(self, key: bytes) -> bool:
        return key in self._store

    def get(self, key: bytes):
        """The entry for ``key`` (refreshed to most-recently-used), or None.
        An entry whose content no longer matches its put-time CRC is deleted
        and reported as None (counted in ``checksum_failures``)."""
        entry = self._store.get(key)
        if entry is None:
            return None
        if _entry_crc(entry) != self._crc[key]:
            del self._store[key]
            del self._crc[key]
            self.checksum_failures += 1
            return None
        self._store.move_to_end(key)
        return entry

    def put(self, key: bytes, entry: dict):
        """Insert a spilled page (no-op refresh when already stored — the
        content under a full-prefix key can never change)."""
        if key in self._store:
            self._store.move_to_end(key)
            return
        self._store[key] = entry
        self._crc[key] = _entry_crc(entry)
        while len(self._store) > self.max_pages:
            k, _ = self._store.popitem(last=False)
            self._crc.pop(k, None)
            self.evictions += 1


class PrefixIndex:
    """Radix-style map from (parent page, token block) to a resident page.

    A prompt's K/V pages are content-addressed by their token block AND the
    identity of the parent page (which transitively pins the whole prefix —
    K/V of a block depends on every token before it).  Entries exist only
    while their page is resident; when a page dies its subtree is unindexed
    so a recycled page id can never be mistaken for the old prefix.
    """

    def __init__(self):
        self._child: dict = {}                         # (parent, bytes) -> page
        self._key_of: dict = {}                        # page -> its key
        self._kids: dict = collections.defaultdict(set)  # parent -> pages
        self._prefix_of: dict = {}      # page -> full prefix bytes (swap key)

    def __len__(self):
        return len(self._child)

    def lookup(self, tokens: np.ndarray, page_size: int) -> list:
        """Longest resident chain of full prompt pages (possibly empty)."""
        chain = []
        parent = -1
        for j in range(len(tokens) // page_size):
            key = (parent, tokens[j * page_size:(j + 1) * page_size].tobytes())
            page = self._child.get(key)
            if page is None:
                break
            chain.append(page)
            parent = page
        return chain

    def register(self, parent: int, block: np.ndarray, page: int,
                 prefix: Optional[bytes] = None):
        """Index ``page`` under ``(parent, block bytes)``; ``prefix`` is the
        FULL prompt byte string through this block (the swap key)."""
        key = (parent, block.tobytes())
        if key in self._child:          # identical block admitted concurrently
            return
        self._child[key] = page
        self._key_of[page] = key
        self._kids[parent].add(page)
        if prefix is not None:
            self._prefix_of[page] = prefix

    def prefix_of(self, page: int) -> Optional[bytes]:
        """Full prefix token bytes of an indexed page (the host-swap key),
        or None when the page is unindexed."""
        return self._prefix_of.get(page)

    def drop(self, page: int):
        """Unindex a dying page and (recursively) its indexed subtree."""
        key = self._key_of.pop(page, None)
        self._prefix_of.pop(page, None)
        if key is not None:
            self._child.pop(key, None)
            self._kids[key[0]].discard(page)
        for child in list(self._kids.pop(page, ())):
            self.drop(child)


@dataclasses.dataclass
class _PagePlan:
    """Admission plan for one request under the paged cache."""
    shared: list                        # resident prefix pages (refs taken)
    swapped: list                       # fresh pages paged in from host swap
    new: list                           # freshly allocated pages
    budget: int                         # decode token budget
    plen: int                           # full prompt length
    pos0: int                           # (len(shared)+len(swapped)) * page_size


@dataclasses.dataclass
class _Partial:
    """A request whose admission prefill runs in CHUNKS interleaved with
    decode rounds (chunked prefill).  It owns a reserved lane (marked
    pending: excluded from decode commits, harvest and admission) and —
    under paging — its full page reservation; the dense prefill sub-cache
    accumulates K/V chunk by chunk until the final chunk's logits seed
    decode and the whole state splices into the lane."""
    req: "Request"
    plan: Optional[_PagePlan]           # page reservation (None = dense cache)
    lane: int
    sub_cache: dict                     # 1-lane dense cache being chunk-filled
    done: int                           # suffix tokens prefilled so far
    pos0: int                           # prefix-shared start offset
    budget: int
    # prefix-seed arrays (seed_tab, seed_len), consumed by the FIRST chunk:
    # seeding must read the live cache AFTER the donor's page install
    seed: Optional[tuple] = None


@dataclasses.dataclass
class _AdmitPlan:
    """Host-side plan for one round's admission sub-batch: everything the
    device tail needs, produced without touching the device (shared by the
    unfused executor and the fused-step assembly)."""
    reqs: list
    plans: list                         # _PagePlan per req (paged) or []
    lanes: np.ndarray                   # (n,) target lanes
    n: int
    n_pad: int                          # pow2-bucketed row count
    toks: np.ndarray                    # (n_pad, plen_pad)
    lens: np.ndarray                    # (n_pad,)
    pos0_pad: np.ndarray                # (n_pad,)
    budgets: np.ndarray                 # (n,)
    specs: list                         # effective SamplingParams per req


@dataclasses.dataclass
class _PartStep:
    """One chunk of one chunked-prefill partial, planned for this round."""
    part: _Partial
    batch: dict                         # numpy arrays (tokens/lens/pos0)
    final: bool
    seed: Optional[tuple] = None        # first-chunk prefix seed (tab, len)


@dataclasses.dataclass
class Request:
    """One generation request.  ``arrival`` is in scheduler decode-step units
    (0 = available immediately); the scheduler never admits a request before
    its arrival time.  ``priority`` orders admission (higher first; FIFO
    within a level) and arms preemption: a page-starved higher-priority
    request may evict a strictly-lower-priority resident lane.
    ``deadline`` / ``ttft_deadline`` are absolute decode-step timestamps
    (the clock of ``arrival``) by which the request must finish / produce
    its first token: infeasible requests are SHED at admission, resident
    ones past ``deadline`` retire with their partial output."""
    rid: int
    tokens: np.ndarray                      # (S,) prompt token ids
    max_new_tokens: Optional[int] = None    # default: engine budget
    arrival: float = 0.0
    extras: Optional[dict] = None           # modality extras (src_emb, ...)
    sampling: Optional[S.SamplingParams] = None  # default: engine default
    priority: int = 0
    deadline: Optional[float] = None        # absolute finish deadline (steps)
    ttft_deadline: Optional[float] = None   # absolute first-token deadline


@dataclasses.dataclass
class PreemptedState:
    """Complete host-side state of a preempted mid-decode request: its page
    blocks (spilled through the host-swap tier's batched gather), dense lane
    carries, decode rows and sampler-state row, as host bits (``_to_host``)
    with each tensor's dtype in ``dtypes``.  Resuming splices everything
    back bit for bit — the lane's PRNG chain position is its committed
    token count, so the resumed stream continues as if the preemption never
    happened."""
    req: Request
    dense: dict                             # per-lane cache carries (host)
    blocks: Optional[dict]                  # page-chain pool blocks (host)
    n_pages: int                            # pages to re-allocate at resume
    row: dict                               # out/tok/ngen/budget rows (host)
    srow: dict                              # sampler-state row (host)
    dtypes: dict                            # "dense.k"/"row.k"/"srow.k" -> dtype
    stoch: bool                             # lane sampled stochastically
    order: int                              # preemption sequence number


class ContinuousBatchingScheduler:
    """Serve a stream of requests over a fixed-capacity lane vector.

    Parameters (the reference's, with the same defaults)
    ----------
    engine: a ``ServeEngine`` (supplies prefill, the decode burst, the fused
        step and the page movers).
    capacity: number of request lanes (the vector length of the batch).
    max_len: cache sequence capacity per lane (>= prompt + budget).  Under
        paging it is rounded UP to a page multiple.
    chunk: decode steps per burst between admission opportunities.
    compact_threshold: occupancy fraction below which live lanes are
        compacted to the front (0 disables compaction).
    page_size: tokens per KV page — enables the PAGED cache.  None = dense.
    pool_pages: physical pages in the pool (default: capacity * pages-per-
        lane, the dense memory footprint).
    prefix_sharing: admit a request whose prompt prefix is already resident
        by bumping page refcounts and prefilling only the suffix (families
        whose full prefix state lives in paged KV only).
    host_swap_pages: capacity (in pages) of the host-side LRU swap store —
        the EVICTION TIER.  Requires paging + prefix sharing; None/0
        disables.
    prefill_chunk: split admission prefill into chunks of at most this many
        tokens, interleaved with decode rounds.  Must be a multiple of the
        family's ``chunked_prefill_granularity`` (ssm/hybrid: ``ssm_chunk``).
        None = whole-prompt prefill.
    fused: run each round's prefill chunk(s) + admission + decode burst
        through one ``ServeEngine._fused_step`` call (the default) instead
        of separate prefill and decode calls.  Both give the same tokens.
    overlap: async host loop — dispatch round N+1 before reading round N's
        results, then harvest round N from the host copies queued after its
        dispatch: ONE blocking sync per round.  Admission sees a
        one-round-stale lane view (under-reports free lanes only);
        ``finished_at`` timestamps shift by the harvest delay.  Requires
        ``fused``.
    src_len: encoder memory length for encdec serving (every request's
        ``src_emb`` extra is zero-padded to this length at submit; required
        for the encdec family, ignored otherwise).
    max_queue: bounded admission queue — a ``submit`` past this many queued
        requests is SHED immediately (recorded result with
        ``finish_reason="shed"``).  None = unbounded (the default).
    obs: a ``repro_torch.obs.Obs`` handle — its metrics registry backs
        ``stats`` and, when it carries a tracer, the round/request timeline
        is recorded at host-side seams (never adding a device sync).
        Default: a FRESH metrics-only handle.
    """

    def __init__(self, engine: ServeEngine, *, capacity: int, max_len: int,
                 chunk: int = 8, compact_threshold: float = 0.5,
                 page_size: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 prefix_sharing: bool = True,
                 host_swap_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 fused: bool = True, overlap: bool = False,
                 src_len: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 obs: Optional[Obs] = None):
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if overlap and not fused:
            raise ValueError("overlap=True requires fused=True (the async "
                             "harvest hangs off the fused dispatch)")
        if engine.cfg.family == "encdec" and src_len is None:
            raise ValueError(
                "encdec serving needs src_len= (the padded encoder memory "
                "length caches are allocated for)")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
            if not chunked_prefill_ok(engine.cfg):
                raise ValueError(
                    f"family '{engine.cfg.family}' does not support chunked "
                    "prefill (needs pos0 suffix-prefill with all cross-chunk "
                    "state in the KV cache)")
            gran = chunked_prefill_granularity(engine.cfg)
            if prefill_chunk % gran:
                raise ValueError(
                    f"prefill_chunk={prefill_chunk} must be a multiple of "
                    f"family '{engine.cfg.family}' chunked-prefill "
                    f"granularity {gran} (chunk boundaries off the SSD scan "
                    "grid would replay a different chunk sequence)")
        self.engine = engine
        self.device = dev = engine.device
        self.fused = fused
        self.overlap = overlap
        self.src_len = src_len
        self.capacity = capacity
        self.chunk = chunk
        self.compact_threshold = compact_threshold
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        self._partials: list[_Partial] = []

        self.queue: collections.deque[Request] = collections.deque()
        self.results: dict[int, dict] = {}
        self._next_rid = 0
        self.now = 0.0                       # decode-step clock
        self.max_queue = max_queue
        # request-lifecycle control plane: live requests by rid (queued,
        # pending, resident or preempted), spilled preempted state awaiting
        # re-admission, and how often each rid was preempted (a finished
        # request with a nonzero count reports PREEMPTED_RESUMED)
        self._live_req: dict[int, Request] = {}
        self._preempted: list[PreemptedState] = []
        self._rid_preempts: dict[int, int] = {}
        self._preempt_seq = 0

        b = capacity
        self.lane_rid = np.full((b,), -1, np.int64)   # -1 = free lane
        if page_size is not None:
            self.n_pages = PG.pages_needed(max_len, page_size)
            max_len = self.n_pages * page_size
            self.pool_pages = pool_pages or capacity * self.n_pages
            # one RESERVED page past the allocatable pool: lanes that are
            # free or retired still decode architecturally inside the burst,
            # and their clamped writes must never land in a page a live
            # request owns — their table rows all point at the trash page
            self.trash_page = self.pool_pages
            self.cache = engine.make_paged_cache(
                b, max_len, page_size=page_size,
                pool_pages=self.pool_pages + 1, src_len=src_len)
            self.cache["page_table"] = torch.full_like(
                self.cache["page_table"], self.trash_page)
            self.allocator = PageAllocator(self.pool_pages)
            self.prefix_index = PrefixIndex()
            self.prefix_sharing = prefix_sharing and getattr(
                get_model(engine.cfg), "PAGED_PREFIX_OK", False)
            self.host_swap = (HostSwapStore(host_swap_pages)
                              if host_swap_pages and self.prefix_sharing
                              else None)
            self.lane_pages: dict[int, list] = {}     # lane -> held page ids
        else:
            if host_swap_pages:
                raise ValueError("host_swap_pages needs a paged cache "
                                 "(set page_size)")
            self.cache = engine.make_cache(b, max_len, src_len=src_len)
            self.prefix_sharing = False
            self.host_swap = None
        self.max_len = max_len
        max_out = engine.max_new_tokens
        self.out_buf = torch.zeros((b, max_out), dtype=torch.int32, device=dev)
        self.tok = torch.full((b,), engine.stop_token, dtype=torch.int32,
                              device=dev)
        self.p = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.n_gen = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.budget = torch.zeros((b,), dtype=torch.int32, device=dev)
        # per-lane sampler state rides the decode carry; a request's row is
        # spliced in at admission and moves with its lane under compaction,
        # so its key chain is a function of its own seed only.  _lane_stoch
        # is the host-side shadow of which lanes sample — when none do, the
        # burst takes the argmax-only body
        self.sstate = S.greedy_state(b, device=dev)
        self._lane_stoch = np.zeros((b,), bool)
        # families whose decode has no cross-lane coupling let the burst
        # narrow to the occupied pow2 lane bucket; MoE's shared expert
        # capacity forbids it
        self._lane_independent = lane_independent_decode(engine.cfg)
        # pending = reserved by a chunk-prefilling request: occupied (never
        # recycled, moves under compaction) but excluded from decode commits
        # and harvest until its final chunk splices in
        self._lane_pending = np.zeros((b,), bool)
        self.obs = obs if obs is not None else Obs()
        reg = self.obs.metrics
        for name, key in _STAT_COUNTERS:
            reg.counter(name, key=key)
        reg.series("occupancy_trace", key="mean_occupancy")
        reg.series("page_occupancy_trace", key="mean_page_occupancy")
        # queue-wait-to-first-token in DECODE STEPS (observed at admission);
        # its p50 is the deadline-feasibility estimate of the control plane
        self._ttft_hist = reg.histogram("ttft_steps", unit="steps",
                                        percentiles=(50,))
        self.stats = reg.stats_view()
        # async-overlap state: the in-flight round's host copies (queued
        # behind its dispatch) plus the lane view they were dispatched
        # under; harvested one round late at the single blocking sync
        self._stash: Optional[dict] = None
        # host mirror of the device n_gen at the last harvest point (stale
        # rows of free lanes included), so active_lane_steps accounting
        # never needs an extra device sync
        self._host_ngen = np.zeros((b,), np.int64)
        # lanes whose admission/final-chunk splice rides THIS round's
        # dispatch (their n_gen becomes 1 in-flight)
        self._round_admitted: list[int] = []
        # wall-clock request timestamps: submitted -> first_token (at the
        # planning of the round that commits it) -> finished (at harvest)
        self.req_times: dict[int, dict] = {}

    def _block_on(self, tree, what: str):
        """THE single place the serve loop waits for the device.

        Copies every tensor of ``tree`` (a tensor or nested dict/tuple/list)
        to the host — all copies queued first, then ONE synchronisation —
        and returns them as numpy arrays (bf16/fp8 as their bits), counted
        once in ``host_syncs`` and traced as a ``sync`` span."""
        self.stats["host_syncs"] += 1
        with self.obs.span("sync", what=what):
            cuda = self.device.type == "cuda"

            def fetch(x):
                if isinstance(x, dict):
                    return {k: fetch(v) for k, v in x.items()}
                if isinstance(x, (tuple, list)):
                    return type(x)(fetch(v) for v in x)
                if x is None or not cuda:
                    return x
                return x.to("cpu", non_blocking=True)

            def host(x):
                if isinstance(x, dict):
                    return {k: host(v) for k, v in x.items()}
                if isinstance(x, (tuple, list)):
                    return type(x)(host(v) for v in x)
                return None if x is None else _to_host(x)

            fetched = fetch(tree)
            if cuda:
                torch.cuda.current_stream(self.device).synchronize()
            return host(fetched)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def submit(self, tokens, *, max_new_tokens: Optional[int] = None,
               arrival: float = 0.0, extras: Optional[dict] = None,
               sampling: Optional[S.SamplingParams] = None,
               priority: int = 0, deadline: Optional[float] = None,
               ttft_deadline: Optional[float] = None) -> int:
        """Queue a request; returns its rid (key into ``run()``'s results).

        ``tokens`` is the 1-D int prompt (<= ``max_len``).  ``arrival`` is
        the decode-step timestamp before which the request is not admissible
        (0.0 = immediately).  ``max_new_tokens`` caps this request's decode
        budget below the engine default; ``sampling`` carries the request's
        own decoding distribution (None: engine default/greedy) — lanes with
        different distributions coexist in one burst.  ``extras`` holds
        per-request side inputs (encdec: ``src_emb`` (S_src, d_model) and
        optionally ``src_lens``).  ``priority`` orders
        admission and arms preemption (see ``Request``); ``deadline`` /
        ``ttft_deadline`` are absolute decode-step timestamps the request
        must finish / first-token by — infeasible ones are shed.
        Submission never touches the device; planning happens at admission.

        Raises :class:`RequestRejected` for a request that could NEVER be
        admitted (over-long prompt, or a worst-case page demand above the
        whole pool), and ``ValueError`` for an encdec request without a
        ``src_emb`` or with one longer than ``src_len``.  A request past a full ``max_queue`` bound is not an error:
        it is recorded immediately as a ``shed`` result and its rid
        returned.
        """
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 1:
            raise ValueError(f"prompt must be 1-D, got shape {tokens.shape}")
        if len(tokens) > self.max_len:
            raise RequestRejected(
                f"prompt length {len(tokens)} exceeds lane capacity "
                f"max_len={self.max_len}")
        if self.page_size is not None:
            own = (self.engine.max_new_tokens if max_new_tokens is None
                   else min(max_new_tokens, self.engine.max_new_tokens))
            n_total = PG.pages_needed(
                min(len(tokens) + own, self.max_len), self.page_size)
            # maximal prefix sharing still leaves a non-empty suffix, so at
            # best (plen-1)//page_size pages come from donors — below that
            # the pool can never cover the request, even empty
            max_shared = ((len(tokens) - 1) // self.page_size
                          if self.prefix_sharing and not extras else 0)
            if n_total - max_shared > self.pool_pages:
                raise RequestRejected(
                    f"request needs {n_total - max_shared} fresh pages "
                    f"worst-case but the pool has only {self.pool_pages}")
        if self.engine.cfg.family == "encdec":
            extras = self._pad_encdec_extras(extras)
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, tokens, max_new_tokens, arrival, extras, sampling,
                      priority, deadline, ttft_deadline)
        self.req_times[rid] = {"submitted": time.perf_counter()}
        self.obs.request_begin(rid, prompt_len=len(tokens),
                               arrival=float(arrival))
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self._shed(req)                 # bounded queue: overload -> shed
            return rid
        self._live_req[rid] = req
        self.queue.append(req)
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a live request wherever it is in its lifecycle; returns
        True when it was cancelled, False when it had already finished (its
        result stands) or was never submitted.

        A queued / preempted / chunk-prefilling request is dropped host-side
        (lane + page reservations released); a RESIDENT request retires
        mid-flight through the same trash-page path harvest uses — its
        partial output is recorded with ``finish_reason="cancelled"``.  The
        overlap stash is flushed first so an in-flight round that actually
        finished the request wins over the cancel."""
        if rid in self.results:
            return False
        if any(r.rid == rid for r in self.queue):
            self.queue = collections.deque(
                r for r in self.queue if r.rid != rid)
            self._finish_cancel(rid, np.zeros((0,), np.int32), 0)
            return True
        for i, ps in enumerate(self._preempted):
            if ps.req.rid == rid:
                del self._preempted[i]
                n = int(ps.row["ngen"])
                self._finish_cancel(rid, ps.row["out"][:n].copy(), n)
                return True
        for i, part in enumerate(self._partials):
            if part.req.rid == rid:
                del self._partials[i]
                self._drop_partial(part)
                self._finish_cancel(rid, np.zeros((0,), np.int32), 0)
                return True
        if (self.lane_rid == rid).any():
            self._flush_stash()
            if rid in self.results:         # finished in the flushed round
                return False
            lanes = np.flatnonzero(self.lane_rid == rid)
            if lanes.size == 0:
                return False
            self.stats["cancelled"] += 1
            self.obs.request_event(rid, "cancelled")
            self._retire_lane(int(lanes[0]), FinishReason.CANCELLED)
            return True
        return False

    def _drop_partial(self, part: _Partial):
        """Release a chunk-prefilling request's reserved lane and pages."""
        self.lane_rid[part.lane] = -1
        self._lane_pending[part.lane] = False
        if part.plan is not None:
            freed = [pid for pid in (part.plan.shared + part.plan.swapped
                                     + part.plan.new)
                     if self.allocator.release(pid)]
            if freed:
                self._spill_pages(freed)

    def _finish_cancel(self, rid: int, tokens, n: int):
        self.stats["cancelled"] += 1
        self.obs.request_event(rid, "cancelled")
        self._record_result(rid, tokens, n, FinishReason.CANCELLED)

    def _shed(self, req: Request):
        """Refuse a request the system cannot serve (full queue or an
        infeasible deadline): record an immediate empty ``shed`` result so
        the caller learns NOW instead of after a futile wait."""
        self.stats["shed"] += 1
        self.obs.request_event(req.rid, "shed")
        self._record_result(req.rid, np.zeros((0,), np.int32), 0,
                            FinishReason.SHED)

    def _record_result(self, rid: int, tokens, n: int,
                       reason: "FinishReason"):
        """Single exit point for every non-harvest finish (cancel, deadline,
        shed, drain):
        records the typed result, closes the request's trace track and drops
        it from the live set."""
        self.results[rid] = {"tokens": np.asarray(tokens, np.int32),
                             "n_generated": int(n),
                             "finished_at": self.now,
                             "finish_reason": reason}
        self.req_times.setdefault(rid, {})["finished"] = time.perf_counter()
        self._live_req.pop(rid, None)
        self.obs.request_end(rid, n_generated=int(n), finished_at=self.now,
                             reason=reason.value)

    def _pad_encdec_extras(self, extras: Optional[dict]) -> dict:
        """Zero-pad a request's encoder memory to the scheduler-wide
        ``src_len`` so every admission sub-batch stacks homogeneously; the
        true length rides along as ``src_lens`` (the attention predicate)."""
        if not extras or "src_emb" not in extras:
            raise ValueError("encdec requests need extras={'src_emb': "
                             "(S_src, d_model) encoder input embeddings}")
        emb = np.asarray(extras["src_emb"])
        if emb.ndim != 2:
            raise ValueError(f"src_emb must be 2-D, got shape {emb.shape}")
        if emb.shape[0] > self.src_len:
            raise ValueError(f"src_emb length {emb.shape[0]} exceeds "
                             f"src_len={self.src_len}")
        sl = int(extras.get("src_lens", emb.shape[0]))
        pad = np.zeros((self.src_len, emb.shape[1]), emb.dtype)
        pad[:emb.shape[0]] = emb
        return dict(extras, src_emb=pad, src_lens=np.int32(sl))

    def occupancy(self) -> float:
        return float((self.lane_rid >= 0).sum()) / self.capacity

    @torch.inference_mode()
    def step(self):
        """One scheduling round: compact, advance chunked prefills, admit,
        decode a chunk, harvest.  Chunked prefills advance by at most one
        chunk per round, so resident lanes decode between a long prompt's
        chunks.  ``fused=True`` (the default) issues the round's device work
        through one ``_fused_step`` call; the unfused loop below is the
        reference it is held against.  ``overlap=True`` additionally
        harvests one round late (a single blocking sync per round)."""
        self._round_admitted = []
        if self.fused:
            return self._step_fused()
        with self.obs.span("round", round=self.stats["steps"]):
            self._maybe_compact()
            self._sweep_deadlines()
            self._maybe_preempt()
            self._try_resume()
            self._advance_partials()
            self._admit()
            occupied = self.lane_rid >= 0
            occ = float(occupied.sum()) / self.capacity
            self.stats["occupancy_trace"].append(occ)
            self.obs.counter("occupancy", occ)
            if self.page_size is not None:
                pocc = self.allocator.live_pages / self.pool_pages
                self.stats["page_occupancy_trace"].append(pocc)
                self.obs.counter("pool_occupancy", pocc)
            if occupied.any():
                eng = self.engine
                gen_before = int(self._block_on(self.n_gen.sum(),
                                                "gen_before"))
                self.stats["dispatches"] += 1
                with self.obs.span("burst", dispatch=True, chunk=self.chunk):
                    (self.cache, self.out_buf, self.tok, self.p,
                     self.n_gen, self.sstate, steps) = eng._decode_chunk(
                        self.cache, self.out_buf, self.tok, self.p,
                        self.n_gen, self.budget, self.sstate,
                        n_steps=self.chunk,
                        stochastic=bool(self._lane_stoch.any()))
                # lanes die mid-chunk and gated steps do nothing: charge
                # what actually ran (each active lane-step commits exactly
                # one token, so the n_gen delta is exact)
                steps = int(self._block_on(steps, "steps"))
                self.stats["decode_steps"] += steps
                self.stats["lane_steps"] += steps * self.capacity
                self.stats["active_lane_steps"] += int(
                    self._block_on(self.n_gen.sum(), "gen_after")) - gen_before
                # the clock is in decode-step units: advance by what ran
                self.now += steps
            else:
                self._idle_tick()
            self.stats["steps"] += 1
            self._harvest()

    def _step_fused(self):
        """One round through the fused step: all host work is
        planning/bookkeeping, all device work is one ``_fused_step`` (or a
        bare burst) call.  Non-overlap mode waits once, at this round's
        harvest; overlap mode stashes this round's host copies and harvests
        the PREVIOUS round instead."""
        eng = self.engine
        obs = self.obs
        with obs.span("round", round=self.stats["steps"]):
            self._maybe_compact()
            self._sweep_deadlines()
            self._maybe_preempt()
            self._try_resume()
            with obs.span("plan"):
                part_steps = self._plan_partial_steps()
                plan = self._plan_admission()
            occupied = self.lane_rid >= 0
            occ = float(occupied.sum()) / self.capacity
            self.stats["occupancy_trace"].append(occ)
            obs.counter("occupancy", occ)
            if self.page_size is not None:
                pocc = self.allocator.live_pages / self.pool_pages
                self.stats["page_occupancy_trace"].append(pocc)
                obs.counter("pool_occupancy", pocc)
            self.stats["steps"] += 1
            if plan is None and not part_steps and not occupied.any():
                self._flush_stash()             # can only be a no-op stash
                self._idle_tick()
                return
            self.stats["dispatches"] += 1
            if plan is None and not part_steps:
                width = self._burst_width()
                with obs.span("dispatch", dispatch=True, kind="decode",
                              width=width or self.capacity):
                    obs.event("burst", chunk=self.chunk,
                              width=width or self.capacity)
                    (self.cache, self.out_buf, self.tok, self.p, self.n_gen,
                     self.sstate, steps_h) = eng._decode_chunk(
                        self.cache, self.out_buf, self.tok, self.p,
                        self.n_gen, self.budget, self.sstate,
                        n_steps=self.chunk,
                        stochastic=bool(self._lane_stoch.any()), width=width)
            else:
                with obs.span("admit", n=plan.n if plan else 0,
                              parts=len(part_steps)):
                    admit = self._assemble_admit(plan)
                    parts, part_final, part_stoch = self._assemble_parts(
                        part_steps)
                admit_stoch = bool(plan is not None and any(
                    self._is_stochastic(s) for s in plan.specs))
                # _lane_stoch / width read AFTER the admit/part assembly
                # committed this round's splices — a just-admitted stochastic
                # lane must get a stochastic burst, and a lane spliced in
                # this round must be inside the burst bucket
                stoch = bool(self._lane_stoch.any())
                width = self._burst_width()
                with obs.span("dispatch", dispatch=True, kind="fused",
                              width=width or self.capacity):
                    obs.event("burst", chunk=self.chunk,
                              width=width or self.capacity)
                    (self.cache, self.out_buf, self.tok, self.p, self.n_gen,
                     self.budget, self.sstate, steps_h,
                     parts_out) = eng._fused_step(
                        self.cache, self.out_buf, self.tok, self.p,
                        self.n_gen, self.budget, self.sstate, admit, parts,
                        n_steps=self.chunk, stochastic=stoch,
                        admit_stoch=admit_stoch, part_final=part_final,
                        part_stoch=part_stoch, max_len=self.max_len,
                        width=width)
                nonfinal = [s.part for s in part_steps if not s.final]
                for part, new_cache in zip(nonfinal, parts_out):
                    part.sub_cache = new_cache
            if self.overlap:
                self._push_stash(steps_h, width)
                return
            steps = int(self._block_on(steps_h, "steps"))
            self.stats["decode_steps"] += steps
            self.stats["lane_steps"] += steps * (width or self.capacity)
            ngen = self._block_on(self.n_gen, "n_gen")
            base = self._host_ngen.copy()
            base[self._round_admitted] = 1
            self.stats["active_lane_steps"] += int(ngen.sum() - base.sum())
            self._host_ngen = ngen.astype(np.int64)
            self.now += steps
            self._harvest()

    def _burst_width(self):
        """Pow2 lane bucket the burst may narrow to, or None for full width.
        Compaction packs live lanes low and whole-prefill admissions fill
        low free lanes first, so the highest occupied non-pending lane
        bounds every lane the burst can commit to; in overlap mode the host
        view lags one harvest and is a SUPERSET of the live lanes
        (conservative).  Only lane-independent
        families qualify — dropping (dead) lanes under MoE changes
        expert-capacity overflow."""
        if not self._lane_independent:
            return None
        cand = np.flatnonzero((self.lane_rid >= 0) & ~self._lane_pending)
        if cand.size == 0:
            return None
        w = _next_pow2(int(cand[-1]) + 1)
        return w if w < self.capacity else None

    def _idle_tick(self):
        """No lane occupied and nothing admissible: fast-forward the
        decode-step clock straight to the next arrival instead of spinning
        chunk-sized idle rounds."""
        nxt = min((r.arrival for r in self.queue), default=None)
        if nxt is not None and nxt > self.now:
            self.now = float(nxt)
        else:
            self.now += self.chunk
        self.obs.event("idle", now=self.now)

    # ------------------------------------------------------------------
    # async overlap: one-round-delayed harvest from host copies
    # ------------------------------------------------------------------

    def _push_stash(self, steps_h, width=None):
        """Queue this round's host copies (``p``, ``out_buf``, ``n_gen`` and
        the steps run, into pinned buffers on the card, behind this round's
        dispatch on the stream, with one event after them), harvest the
        PREVIOUS round, then snapshot the post-harvest lane view the new
        stash must be read under (lanes freed just now must not be
        harvested twice next round).  The stash owns its bytes: on the card
        the next burst overwrites ``p``/``out_buf``/``n_gen`` in place (the
        graphs' static carry)."""
        cuda = self.device.type == "cuda"
        host = {}
        for k, t in (("p", self.p), ("out", self.out_buf),
                     ("ngen", self.n_gen), ("steps", steps_h)):
            buf = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                              pin_memory=cuda)
            host[k] = buf.copy_(t, non_blocking=cuda)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        prev = self._stash
        self._stash = dict(host, event=event, width=width,
                           admitted=list(self._round_admitted))
        if prev is not None:
            self._harvest_stash(prev)
        self._stash["lane_rid"] = self.lane_rid.copy()
        self._stash["pending"] = self._lane_pending.copy()

    def _flush_stash(self):
        if self._stash is not None:
            st, self._stash = self._stash, None
            self._harvest_stash(st)

    def _harvest_stash(self, st):
        """The round's SINGLE blocking sync: wait for the stash's event (its
        host copies have landed), account the decode burst, and harvest
        finished lanes under the lane view the stash was created with (a
        compaction since permuted it: ``perm``)."""
        with self.obs.span("harvest", delayed=True):
            self.stats["host_syncs"] += 1
            with self.obs.span("sync", what="harvest"):
                if st["event"] is not None:
                    st["event"].synchronize()
            p, out, ngen = (_to_host(st[k]) for k in ("p", "out", "ngen"))
            if "perm" in st:
                p, out, ngen = p[st["perm"]], out[st["perm"]], ngen[st["perm"]]
            steps = int(st["steps"])
            self.stats["decode_steps"] += steps
            self.stats["lane_steps"] += steps * (st["width"] or self.capacity)
            base = self._host_ngen.copy()
            base[st["admitted"]] = 1
            self.stats["active_lane_steps"] += int(ngen.sum() - base.sum())
            self._host_ngen = ngen.astype(np.int64)
            for lane, v in st.get("resumed_fix", {}).items():
                self._host_ngen[lane] = v
            self.now += steps
            finished = np.flatnonzero((st["lane_rid"] >= 0) & ~p
                                      & ~st["pending"])
            if finished.size == 0:
                return
            self._retire_finished(finished, st["lane_rid"], out, ngen)

    def run(self) -> dict[int, dict]:
        """Drain the queue and all live lanes; returns ``{rid: result}``.

        Calls ``step()`` until no request is queued or resident.  Each
        result carries ``tokens`` (the generated ids, stop token excluded),
        ``n_generated``, ``finished_at`` and ``finish_reason``; per-request
        timing lands in ``req_times`` and aggregate counters in ``stats``.
        ``run`` is resumable: more ``submit``s after it returns and a second
        ``run()`` continue on the same lanes/pages/prefix state — with the
        host-swap tier on, later calls hit prefixes earlier calls retired.

        ``run`` never strands state: a ``KeyboardInterrupt`` drains the loop
        (stash flushed, every live request recorded with partial output and
        ``finish_reason="cancelled"``, allocator leak-free) and RETURNS the
        partial results; any other exception drains the same way and then
        re-raises.
        """
        try:
            while (self.queue or self._preempted
                   or (self.lane_rid >= 0).any()):
                self.step()
        except KeyboardInterrupt:
            self._abort_drain()
        except BaseException:
            self._abort_drain()
            raise
        finally:
            self._flush_stash()
        return self.results

    @torch.inference_mode()
    def _abort_drain(self):
        """Tear the serve loop down to a consistent idle state: flush the
        in-flight stash, record partial ``cancelled`` results for every live
        request (resident, chunk-prefilling, preempted or queued) and free
        their lanes/pages.  Asserts the allocator ends leak-free."""
        try:
            self._flush_stash()
        except Exception:           # a broken device must not block drain
            self._stash = None
        for part in list(self._partials):
            self.cancel(part.req.rid)
        for lane in np.flatnonzero(self.lane_rid >= 0):
            rid = int(self.lane_rid[int(lane)])
            self.stats["cancelled"] += 1
            self.obs.request_event(rid, "cancelled")
            self._retire_lane(int(lane), FinishReason.CANCELLED)
        for ps in list(self._preempted):
            self.cancel(ps.req.rid)
        for req in list(self.queue):
            self.cancel(req.rid)
        if self.page_size is not None:
            assert self.allocator.live_pages == 0, (
                f"page leak after drain: {self.allocator.live_pages} "
                "pages still held with no resident lane")

    # ------------------------------------------------------------------
    # request-lifecycle control plane: deadlines, preemption, resume
    # ------------------------------------------------------------------

    def _retire_lane(self, lane: int, reason: "FinishReason"):
        """Retire a RESIDENT lane mid-flight (cancel/deadline/drain): read
        its partial output, record the typed result and free the lane + its
        page chain through the same trash-page path harvest uses.  The
        caller must have flushed the stash first — retiring under an
        unharvested snapshot would harvest the lane twice.  A device that
        fails the read must not block the drain: the lane then retires with
        no output."""
        rid = int(self.lane_rid[lane])
        try:
            out, ngen = self._block_on((self.out_buf[lane], self.n_gen[lane]),
                                       "retire")
            n = int(ngen)
            out = out[:n].copy()
        except Exception:
            n, out = 0, np.zeros((0,), np.int32)
        self._record_result(rid, out, n, reason)
        self.p = P.set_lanes(self.p, lane, False)
        self.lane_rid[lane] = -1
        self._lane_stoch[lane] = False
        # keep the host n_gen mirror at the DEVICE value (stale rows of free
        # lanes are part of the active_lane_steps accounting)
        self._host_ngen[lane] = n
        if self.page_size is not None:
            freed = [pid for pid in self.lane_pages.pop(lane, [])
                     if self.allocator.release(pid)]
            if freed:
                try:
                    self._spill_pages(freed)
                except Exception:
                    for pid in freed:
                        self.prefix_index.drop(pid)
            self.cache["page_table"] = P.set_lanes(
                self.cache["page_table"], lane, self.trash_page)

    def _sweep_deadlines(self):
        """Retire resident lanes whose finish deadline has passed (partial
        output, ``finish_reason="deadline"``).  The cheap pre-check keeps
        the overlap loop's one sync a round: the stash is only flushed when
        some lane is actually over deadline."""
        over = [int(l) for l in np.flatnonzero(self.lane_rid >= 0)
                if not self._lane_pending[int(l)]
                and (r := self._live_req.get(int(self.lane_rid[int(l)])))
                is not None and r.deadline is not None
                and self.now > r.deadline]
        if not over:
            return
        self._flush_stash()
        for lane in over:
            rid = int(self.lane_rid[lane])
            req = self._live_req.get(rid)
            if rid < 0 or req is None:      # finished in the flushed round
                continue
            self.stats["deadline_misses"] += 1
            self.obs.request_event(rid, "deadline")
            self._retire_lane(lane, FinishReason.DEADLINE)

    # ------------------------------------------------------------------
    # lane lifecycle
    # ------------------------------------------------------------------

    def _free_lanes(self):
        return np.flatnonzero(self.lane_rid < 0)

    def _due(self, req: Request) -> bool:
        return req.arrival <= self.now

    def _budget_for(self, req: Request, plen: int) -> int:
        """The request's decode-token budget: its own cap, clamped to the
        engine budget and the lane's remaining cache extent.  THE single
        definition — paged planning, whole-prefill admission and
        chunked-prefill reservation must all agree."""
        own = (self.engine.max_new_tokens if req.max_new_tokens is None
               else req.max_new_tokens)
        return min(own, self.engine.max_new_tokens, self.max_len - plen)

    def _plan_pages(self, req: Request) -> Optional[_PagePlan]:
        """Reserve pages for one request: longest resident prompt prefix is
        SHARED (refcount bump, no prefill), then — with the eviction tier —
        the chain is EXTENDED through host-swapped pages (fresh allocations
        whose content pages in from the host store), and the rest is freshly
        allocated for suffix prefill.  Returns None — and touches nothing —
        when the pool can't cover it."""
        ps = self.page_size
        plen = len(req.tokens)
        budget = self._budget_for(req, plen)
        shared: list = []
        swap_entries: list = []
        if self.prefix_sharing and not req.extras:
            shared = self.prefix_index.lookup(req.tokens, ps)
            # the suffix prefill must be non-empty (the last prompt token's
            # logits seed decode), so never share the whole prompt
            while shared and len(shared) * ps >= plen:
                shared.pop()
            if self.host_swap is not None:
                # extend the resident chain through the host store (same
                # non-empty-suffix guard), VERIFYING each entry's checksum
                # on the way — a corrupt hit degrades the rest of the chain
                # to cold prefill, never to wrong tokens
                cf0 = self.host_swap.checksum_failures
                j = len(shared)
                while (j + 1) * ps < plen:
                    entry = self.host_swap.get(
                        req.tokens[:(j + 1) * ps].tobytes())
                    if entry is None:
                        break
                    swap_entries.append(entry)
                    j += 1
                cf = self.host_swap.checksum_failures - cf0
                if cf:
                    self.stats["swap_checksum_failures"] += cf
        n_total = PG.pages_needed(min(plen + budget, self.max_len), ps)
        new = self.allocator.alloc(n_total - len(shared))
        if new is None:
            self.stats["page_waits"] += 1
            return None
        for pid in shared:
            self.allocator.retain(pid)
        swapped, new = new[:len(swap_entries)], new[len(swap_entries):]
        if swapped:
            self._page_in(swapped, swap_entries)
            self.stats["session_hits"] += 1
            self.stats["session_hit_tokens"] += len(swapped) * ps
        if shared:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += len(shared) * ps
        return _PagePlan(shared=shared, swapped=swapped, new=new,
                         budget=budget, plen=plen,
                         pos0=(len(shared) + len(swapped)) * ps)

    def _unplan_pages(self, plan: _PagePlan):
        """Roll back a reservation for a candidate that didn't fit the
        admission group after all (releases never free a donor's pages).
        Paged-in swap pages release to the free list; their content stays
        in the host store, so a re-plan just pages them in again."""
        for pid in plan.new + plan.swapped + plan.shared:
            self.allocator.release(pid)
        if plan.shared:
            self.stats["prefix_hits"] -= 1
            self.stats["prefix_hit_tokens"] -= len(plan.shared) * self.page_size
        if plan.swapped:
            self.stats["session_hits"] -= 1
            self.stats["session_hit_tokens"] -= (len(plan.swapped)
                                                 * self.page_size)

    def _est_ttft(self) -> float:
        """Estimated queue-wait-to-first-token in decode steps: the p50 of
        the ``ttft_steps`` histogram (0 before any admission)."""
        h = self._ttft_hist
        return float(h.percentile(50)) if h.count else 0.0

    def _shed_infeasible(self, req: Request) -> bool:
        """True when the request can no longer meet its deadlines: its
        predicted first-token time — now, or its arrival plus the observed
        p50 queue wait, whichever is later — is past ``ttft_deadline`` or
        ``deadline``.  Pure estimate, no device touch."""
        if req.ttft_deadline is None and req.deadline is None:
            return False
        first = max(self.now, req.arrival + self._est_ttft())
        if req.ttft_deadline is not None and first > req.ttft_deadline:
            return True
        return req.deadline is not None and first > req.deadline

    def _fresh_pages_needed(self, req: Request) -> int:
        """Pages ``_plan_pages`` would freshly allocate for this request —
        the same lookup, side-effect-free (no refcounts, no stats).  Drives
        the preemption trigger: preempt only when the top-priority waiter
        cannot get this many pages from the free list."""
        if self.page_size is None:
            return 0
        ps = self.page_size
        plen = len(req.tokens)
        shared: list = []
        if self.prefix_sharing and not req.extras:
            shared = self.prefix_index.lookup(req.tokens, ps)
            while shared and len(shared) * ps >= plen:
                shared.pop()
        budget = self._budget_for(req, plen)
        return (PG.pages_needed(min(plen + budget, self.max_len), ps)
                - len(shared))

    def _maybe_preempt(self):
        """Priority preemption trigger, run once per round before planning:
        while the highest-priority waiting request (queued-and-due or
        already preempted) is starved — no free lane, or fewer free pages
        than it needs — evict the lowest-priority resident lane whose
        priority is STRICTLY below it.  Equal priorities never preempt each
        other, so all-default-priority traffic behaves exactly as before."""
        for _ in range(self.capacity):
            best_q = None
            for r in self.queue:
                if self._due(r) and (best_q is None
                                     or r.priority > best_q.priority):
                    best_q = r
            top_pri = None if best_q is None else best_q.priority
            top_need = None
            for ps in self._preempted:
                if top_pri is None or ps.req.priority > top_pri:
                    top_pri, top_need = ps.req.priority, ps.n_pages
            if top_pri is None:
                return
            # victim check BEFORE the page-need lookup: with all-equal
            # priorities no lane can ever be evicted, and the prefix-index
            # walk would be pure overhead
            victim = self._victim_lane(top_pri)
            if victim is None:
                return
            if top_need is None:
                top_need = self._fresh_pages_needed(best_q)
            starved = len(self._free_lanes()) == 0 or (
                self.page_size is not None
                and top_need > self.allocator.free_pages)
            if not starved:
                return
            self._preempt_lane(victim)

    def _victim_lane(self, above: int) -> Optional[int]:
        """Lowest-priority resident non-pending lane strictly below
        ``above`` (ties: lowest lane index — deterministic), or None."""
        best = None
        for lane in np.flatnonzero(self.lane_rid >= 0):
            lane = int(lane)
            if self._lane_pending[lane]:
                continue
            req = self._live_req.get(int(self.lane_rid[lane]))
            if req is None or req.priority >= above:
                continue
            if best is None or req.priority < best[0]:
                best = (req.priority, lane)
        return None if best is None else best[1]

    def _preempt_lane(self, lane: int):
        """Spill a resident lane's COMPLETE state to the host and free it:
        page blocks through the host-swap gather, dense carries + decode
        rows + sampler row through ``_spill_lane`` — one blocking sync for
        all of it.  The request re-queues as a ``PreemptedState``; resuming
        splices everything back bit for bit."""
        self._flush_stash()
        rid = int(self.lane_rid[lane])
        if rid < 0:                         # finished in the flushed round
            return
        req = self._live_req[rid]
        eng = self.engine
        stoch = bool(self._lane_stoch[lane])
        with self.obs.span("preempt", rid=rid, lane=lane):
            self.stats["dispatches"] += 1
            dense_h, row_h, srow_h = eng._spill_lane(
                self.cache, self.out_buf, self.tok, self.n_gen, self.budget,
                self.sstate, lane)
            blocks_h = None
            pages: list = []
            if self.page_size is not None:
                pages = self.lane_pages.get(lane, [])
                if pages:
                    kpad = _next_pow2(len(pages))
                    pids = np.full((kpad,), self.trash_page, np.int32)
                    pids[:len(pages)] = pages
                    self.stats["dispatches"] += 1
                    blocks_h = eng._gather_blocks(
                        self.cache, torch.as_tensor(pids, device=self.device))
            dtypes = {f"{name}.{k}": v.dtype
                      for name, tree in (("dense", dense_h), ("row", row_h),
                                         ("srow", srow_h))
                      for k, v in tree.items()}
            # _block_on's leaves are host copies: PreemptedState owns its
            # bytes (on the card the next burst overwrites the carry)
            dense, row, srow, blocks = self._block_on(
                (dense_h, row_h, srow_h, blocks_h), "preempt")
            if blocks is not None:
                blocks = {k: b[:len(pages)] for k, b in blocks.items()}
            if self.page_size is not None:
                freed = [pid for pid in self.lane_pages.pop(lane, [])
                         if self.allocator.release(pid)]
                if freed:
                    self._spill_pages(freed)
                self.cache["page_table"] = P.set_lanes(
                    self.cache["page_table"], lane, self.trash_page)
            self.p = P.set_lanes(self.p, lane, False)
            self.lane_rid[lane] = -1
            self._lane_stoch[lane] = False
            self._host_ngen[lane] = int(row["ngen"])
            self._preempted.append(PreemptedState(
                req=req, dense=dense, blocks=blocks, n_pages=len(pages),
                row=row, srow=srow, dtypes=dtypes, stoch=stoch,
                order=self._preempt_seq))
            self._preempt_seq += 1
            self.stats["preemptions"] += 1
            self._rid_preempts[rid] = self._rid_preempts.get(rid, 0) + 1
            self.obs.request_event(rid, "preempted", lane=lane,
                                   n_gen=int(row["ngen"]))

    def _try_resume(self):
        """Re-admit preempted requests (highest priority first, FIFO within
        a level) as soon as a lane and their full page-chain allocation are
        available.  Resume takes the LOWEST free lane — the same fill order
        admission uses, so burst narrowing stays valid."""
        if not self._preempted:
            return
        # never resume BELOW a due queued request's priority: preemption
        # just freed resources for it, and resuming the victim right back
        # would thrash (preempt -> resume -> preempt)
        top_queued = max((r.priority for r in self.queue if self._due(r)),
                         default=None)
        still: list[PreemptedState] = []
        for ps in sorted(self._preempted,
                         key=lambda s: (-s.req.priority, s.order)):
            if top_queued is not None and ps.req.priority < top_queued:
                still.append(ps)
                continue
            free = self._free_lanes()
            if len(free) == 0:
                still.append(ps)
                continue
            new = None
            if self.page_size is not None and ps.n_pages:
                new = self.allocator.alloc(ps.n_pages)
                if new is None:
                    self.stats["page_waits"] += 1
                    still.append(ps)
                    continue
            self._resume_state(ps, int(free[0]), new)
        self._preempted = still

    def _resume_state(self, ps: PreemptedState, lane: int, new_pages):
        """Splice a ``PreemptedState`` back into ``lane``: scatter its page
        blocks into freshly allocated pages (the batched write of swap-in),
        rebuild the page-table row (tail-padded with the last page, the
        clamped-write containment rule), then restore dense carries + decode
        rows + sampler row via ``_resume_lane``.  The resumed chain is NOT
        re-registered in the prefix index: its pages are private now, and a
        later prompt sharing this prefix pays a cold prefill."""
        eng = self.engine
        dev = self.device
        rid = ps.req.rid
        table_row = None
        back = lambda name, tree: {
            k: _to_device(v, ps.dtypes[f"{name}.{k}"], dev)
            for k, v in tree.items()}
        with self.obs.span("resume", rid=rid, lane=lane):
            if self.page_size is not None and ps.n_pages:
                kpad = _next_pow2(ps.n_pages)
                pids = np.full((kpad,), self.trash_page, np.int32)
                pids[:ps.n_pages] = new_pages
                blocks = {}
                for pk, b in ps.blocks.items():
                    pad = np.zeros((kpad - ps.n_pages,) + b.shape[1:],
                                   b.dtype)
                    blocks[pk] = _to_device(np.concatenate([b, pad]),
                                            self.cache[pk].dtype, dev)
                self.stats["dispatches"] += 1
                self.cache = eng._scatter_blocks(
                    self.cache, torch.as_tensor(pids, device=dev), blocks)
                tab = np.full((self.n_pages,), new_pages[-1], np.int32)
                tab[:ps.n_pages] = new_pages
                table_row = torch.as_tensor(tab, device=dev)
                self.lane_pages[lane] = list(new_pages)
                self.stats["resume_page_ins"] += ps.n_pages
            self.stats["dispatches"] += 1
            (self.cache, self.out_buf, self.tok, self.p, self.n_gen,
             self.budget, self.sstate) = eng._resume_lane(
                self.cache, self.out_buf, self.tok, self.p, self.n_gen,
                self.budget, self.sstate, lane, back("dense", ps.dense),
                back("row", ps.row), back("srow", ps.srow), table_row)
            self.lane_rid[lane] = rid
            self._lane_stoch[lane] = ps.stoch
            self._host_ngen[lane] = int(ps.row["ngen"])
            if self._stash is not None:
                # the in-flight round's n_gen row for this lane may belong
                # to a PREVIOUS occupant: pin the post-harvest mirror back
                # to the resumed value when that stash lands
                self._stash.setdefault("resumed_fix", {})[lane] = int(
                    ps.row["ngen"])
            self.obs.request_event(rid, "resumed", lane=lane)

    def _plan_admission(self) -> Optional[_AdmitPlan]:
        """Scan the queue and plan this round's admission sub-batch — pure
        host work (no device touch beyond allocator/prefix bookkeeping and
        page-ins).

        The whole queue is scanned (a not-yet-due request must not block due
        ones behind it); FIFO order is preserved among the due.  One
        prefill sub-batch must stack homogeneously, so only requests with
        the same extras keys are admitted together.  Under paging each
        candidate must also fit the page pool
        (``_plan_pages``); prefix-hit rows prefill only their suffix.

        With ``prefill_chunk`` set, a request whose (suffix) prompt exceeds
        the chunk becomes a chunked-prefill PARTIAL instead: it claims a lane
        (from the tail of the free list, so whole-prefill admissions keep the
        head) and its pages, then prefills chunk by chunk across rounds.
        """
        free = self._free_lanes()
        batch_reqs: list[Request] = []
        plans: list[_PagePlan] = []
        queue = list(self.queue)
        keep = [True] * len(queue)          # stays queued for a later round
        extras_keys = None
        n_claimed = 0                       # lanes claimed by new partials
        suffix_max = pos0_max = 0
        for qi in sorted(range(len(queue)), key=lambda i: -queue[i].priority):
            req = queue[qi]
            if not self._due(req):
                continue
            if self._shed_infeasible(req):  # can't meet its deadline: shed
                keep[qi] = False
                self._shed(req)
                continue
            if len(batch_reqs) + n_claimed >= len(free):
                continue
            keys = frozenset(req.extras) if req.extras else frozenset()
            # extras ride chunked prefill only when they are per-request
            # constants the FIRST chunk consumes whole (encdec's encoder
            # memory); token-aligned extras would need per-chunk slicing
            chunkable = self.prefill_chunk is not None and (
                not req.extras or self.engine.cfg.family == "encdec")
            if extras_keys is not None and keys != extras_keys:
                continue
            if self.page_size is None and chunkable \
                    and len(req.tokens) > self.prefill_chunk:
                self._start_partial(req, None, free[len(free) - 1 - n_claimed])
                n_claimed += 1
                keep[qi] = False
                continue
            if self.page_size is not None:
                plan = self._plan_pages(req)
                if plan is None:                    # pool exhausted: wait
                    continue
                if chunkable and plan.plen - plan.pos0 > self.prefill_chunk:
                    self._start_partial(req, plan,
                                        free[len(free) - 1 - n_claimed])
                    n_claimed += 1
                    keep[qi] = False
                    continue
                # group-fit guard: the prefill writes ONE padded suffix block
                # per row at its pos0, which must not run past max_len (it
                # would shift a prefix-shared row's K/V over its seeded
                # prefix).  Only co-admit candidates whose shared padded
                # width still fits every row's offset; a lone candidate
                # always fits.
                s_max = max(suffix_max, plan.plen - plan.pos0)
                p_max = max(pos0_max, plan.pos0)
                if min(_next_pow2(s_max), self.max_len - p_max) < s_max:
                    self._unplan_pages(plan)        # wait for a better group
                    continue
                suffix_max, pos0_max = s_max, p_max
                plans.append(plan)
            batch_reqs.append(req)
            keep[qi] = False
            if extras_keys is None:
                extras_keys = keys
        self.queue = collections.deque(
            q for i, q in enumerate(queue) if keep[i])
        if not batch_reqs:
            return None
        n = len(batch_reqs)
        lanes = free[:n]
        pos0 = np.array([pl.pos0 for pl in plans] or [0] * n, np.int32)
        # bucket the prefill shape (rows to a power of two, columns to a
        # power of two capped at max_len) so a ragged trace runs a BOUNDED
        # set of prefill shapes
        n_pad = min(_next_pow2(n), self.capacity)
        plen = max(len(r.tokens) - int(pos0[i])
                   for i, r in enumerate(batch_reqs))
        # cap the bucket so pos0 + plen_pad <= max_len for every admitted row
        plen_pad = min(_next_pow2(plen), self.max_len - int(pos0.max()))
        toks = np.zeros((n_pad, plen_pad), np.int32)
        lens = np.ones((n_pad,), np.int32)          # dummy rows: 1-token pad
        pos0_pad = np.zeros((n_pad,), np.int32)
        for i, r in enumerate(batch_reqs):
            suffix = r.tokens[pos0[i]:]
            toks[i, :len(suffix)] = suffix
            lens[i] = len(suffix)
            pos0_pad[i] = pos0[i]
        self.stats["prefill_tokens"] += int(lens[:n].sum())
        specs = [self._effective_spec(r) for r in batch_reqs]
        if plans:
            budgets = np.asarray([pl.budget for pl in plans], np.int32)
        else:
            budgets = np.asarray([self._budget_for(r, int(lens[i]))
                                  for i, r in enumerate(batch_reqs)], np.int32)
        t = time.perf_counter()
        for i, r in enumerate(batch_reqs):
            self.req_times[r.rid]["first_token"] = t
            # queue-wait-to-first-token in steps
            self._ttft_hist.record(self.now - r.arrival)
            pl = plans[i] if plans else None
            self.obs.request_event(
                r.rid, "admitted", lane=int(lanes[i]),
                **({"shared_pages": len(pl.shared),
                    "swapped_pages": len(pl.swapped),
                    "new_pages": len(pl.new)} if pl is not None else {}))
            self.obs.request_event(r.rid, "first_token")
        return _AdmitPlan(reqs=batch_reqs, plans=plans, lanes=lanes, n=n,
                          n_pad=n_pad, toks=toks, lens=lens,
                          pos0_pad=pos0_pad, budgets=budgets, specs=specs)

    def _admit_batch(self, plan: _AdmitPlan) -> dict:
        """Host-side prefill batch for an admission plan (numpy leaves: the
        engine moves them to the device in one place).  The requests'
        extras stack row by row; dummy rows' ``src_lens`` pad to 1, not 0
        (an all-masked attention row would give NaNs), the rest to zeros."""
        batch = {"tokens": plan.toks, "lens": plan.lens}
        if self.page_size is not None:
            batch["pos0"] = plan.pos0_pad
        r0 = plan.reqs[0]
        for k in r0.extras or ():
            proto = np.asarray(r0.extras[k])
            pad = (np.ones_like(proto) if k == "src_lens"
                   else np.zeros_like(proto))
            batch[k] = np.stack([np.asarray(r.extras[k]) for r in plan.reqs]
                                + [pad] * (plan.n_pad - plan.n))
        return batch

    def _admit(self):
        """Unfused admission executor: prefill the planned sub-batch as its
        own call and splice it into the recycled lanes."""
        plan = self._plan_admission()
        if plan is None:
            return
        eng = self.engine
        dev = self.device
        n, n_pad, lanes = plan.n, plan.n_pad, plan.lanes
        batch = self._admit_batch(plan)
        sub_cache = eng.make_cache(n_pad, self.max_len, src_len=self.src_len)
        if self.page_size is not None:
            sub_cache = self._seed_shared_prefix(sub_cache, plan.plans, n_pad)
        self.stats["dispatches"] += 1
        with self.obs.span("admit", dispatch=True, n=n):
            logits, sub_cache = eng._prefill(eng.params, batch, sub_cache)
        # per-request sampler rows: built from each request's OWN spec/seed
        # (dummy pad rows are greedy with a zero key)
        sub_state = S.lane_state(plan.specs, n_pad, device=dev)
        if any(self._is_stochastic(s) for s in plan.specs):
            first_tok, sub_state = eng._sample(logits, sub_state)
        else:
            # all-greedy admission skips the stochastic pipeline (greedy
            # keys are never read, so leaving them unsplit is inert)
            first_tok = eng._sample(logits)
        first_tok = first_tok[:n]
        if self.page_size is not None:
            self._copy_pages(sub_cache, plan.plans, lanes)
            for req, pl in zip(plan.reqs, plan.plans):
                self._register_prefix(req, pl)
        keep = torch.arange(n, device=dev)
        if n_pad > n:                               # drop the dummy rows
            sub_cache = eng.gather_lanes(sub_cache, keep)

        # ---- splice the sub-batch into the recycled lanes ----
        lane_idx = torch.as_tensor(lanes, dtype=torch.int64, device=dev)
        self.cache = eng.slot_update(self.cache, lane_idx, sub_cache)
        self.sstate = S.slot_update(self.sstate, lane_idx,
                                    S.gather_lanes(sub_state, keep))
        budgets = torch.as_tensor(plan.budgets, device=dev)
        self.tok = P.set_lanes(self.tok, lane_idx, first_tok)
        seeds = torch.zeros((n, self.out_buf.shape[1]), dtype=torch.int32,
                            device=dev)
        seeds[:, 0] = first_tok
        self.out_buf = P.set_lanes(self.out_buf, lane_idx, seeds)
        self.n_gen = P.set_lanes(self.n_gen, lane_idx, 1)
        self.budget = P.set_lanes(self.budget, lane_idx, budgets)
        alive = (first_tok != eng.stop_token) & (budgets > 1)
        self.p = P.set_lanes(self.p, lane_idx, alive)
        for i, r in enumerate(plan.reqs):
            self.lane_rid[lanes[i]] = r.rid
            self._lane_stoch[lanes[i]] = self._is_stochastic(plan.specs[i])
            self._round_admitted.append(int(lanes[i]))

    def _assemble_admit(self, plan: Optional[_AdmitPlan]) -> Optional[dict]:
        """Turn an admission plan into the fused step's ``admit`` input:
        padded rows aimed at out-of-range lanes (the splices drop them) and
        padded page copies at the trash page.  Also commits the host-side
        lane bookkeeping the splice implies."""
        if plan is None:
            return None
        lanes = np.full((plan.n_pad,), self.capacity, np.int32)
        lanes[:plan.n] = plan.lanes
        budgets = np.zeros((plan.n_pad,), np.int32)
        budgets[:plan.n] = plan.budgets
        admit = {"batch": self._admit_batch(plan),
                 "lanes": lanes,
                 "budgets": budgets,
                 "sub_state": S.lane_state(plan.specs, plan.n_pad,
                                           device=self.device)}
        if self.page_size is not None:
            seed = self._seed_arrays(plan.plans, plan.n_pad)
            if seed is not None:
                admit["seed_tab"], admit["seed_len"] = seed
            rows, cols, dsts, tab_rows = self._page_copy_plan(plan.plans)
            kpad = _next_pow2(len(rows))
            rows_a = np.zeros((kpad,), np.int32)
            rows_a[:len(rows)] = rows
            cols_a = np.zeros((kpad,), np.int32)
            cols_a[:len(cols)] = cols
            dsts_a = np.full((kpad,), self.trash_page, np.int32)
            dsts_a[:len(dsts)] = dsts
            tab_full = np.zeros((plan.n_pad, self.n_pages), np.int32)
            tab_full[:plan.n] = tab_rows
            admit["copy_rows"] = rows_a
            admit["copy_cols"] = cols_a
            admit["copy_dsts"] = dsts_a
            admit["tab_rows"] = tab_full
            for i, pl in enumerate(plan.plans):
                self.lane_pages[int(plan.lanes[i])] = (pl.shared + pl.swapped
                                                       + pl.new)
            for req, pl in zip(plan.reqs, plan.plans):
                self._register_prefix(req, pl)
        for i, r in enumerate(plan.reqs):
            self.lane_rid[plan.lanes[i]] = r.rid
            self._lane_stoch[plan.lanes[i]] = self._is_stochastic(
                plan.specs[i])
            self._round_admitted.append(int(plan.lanes[i]))
        return admit

    def _effective_spec(self, req: Request):
        """The request's own SamplingParams, or the engine-wide default —
        decorrelated per request by folding its rid into the default's key
        (``fold_in`` can never collide with another request's explicit
        seed, and it matches the one-shot engine's broadcast path when
        submission order equals lane order)."""
        if req.sampling is not None:
            return req.sampling
        d = self.engine.default_sampling
        if d is None or d.greedy or d.temperature <= 0 or d.fold is not None:
            return d
        return dataclasses.replace(d, fold=req.rid)

    @staticmethod
    def _is_stochastic(spec) -> bool:
        return not (spec is None or spec.greedy or spec.temperature <= 0)

    # ------------------------------------------------------------------
    # chunked prefill (admission interleaved with decode rounds)
    # ------------------------------------------------------------------

    def _start_partial(self, req: Request, plan: Optional[_PagePlan],
                       lane: int):
        """Reserve a lane (and, under paging, the request's full page plan)
        and begin prefilling its prompt in chunks.  The lane is marked
        pending: it keeps decoding architecturally inside the burst (writes
        land beyond-pos garbage / in the trash page) but is excluded from
        commits, harvest and admission until the final chunk splices."""
        eng = self.engine
        lane = int(lane)
        budget = (plan.budget if plan is not None
                  else self._budget_for(req, len(req.tokens)))
        sub_cache = eng.make_cache(1, self.max_len, src_len=self.src_len)
        # the first chunk attends over the prefix pages, resident or paged
        # in from the host store alike (``_seed_arrays`` takes both; the
        # reference seeds resident pages only, so a chunked request whose
        # prefix came back from the swap tier alone attends over zeros)
        seed = self._seed_arrays([plan], 1) if plan is not None else None
        self.lane_rid[lane] = req.rid
        self._lane_pending[lane] = True
        self._partials.append(_Partial(
            req=req, plan=plan, lane=lane, sub_cache=sub_cache, done=0,
            pos0=plan.pos0 if plan is not None else 0, budget=budget,
            seed=seed))
        self.obs.request_event(req.rid, "prefill_start", lane=lane,
                               suffix=len(req.tokens)
                               - (plan.pos0 if plan is not None else 0))

    def _plan_partial_steps(self) -> list[_PartStep]:
        """Plan at most ONE prefill chunk per pending request — pure host
        work shared by the unfused executor and the fused assembly.  Chunk
        widths bucket to powers of two capped at the row's remaining extent.
        Final chunks commit their host-side bookkeeping here (prefix
        registration, pending clear) so this round's admission planning
        already sees the spliced state."""
        if not self._partials:
            return []
        steps: list[_PartStep] = []
        still: list[_Partial] = []
        t = None
        for part in self._partials:
            toks = part.req.tokens
            start = part.pos0 + part.done
            n = min(self.prefill_chunk, len(toks) - start)
            width = min(_next_pow2(n), self.max_len - start)
            buf = np.zeros((1, width), np.int32)
            buf[0, :n] = toks[start:start + n]
            batch = {"tokens": buf,
                     "lens": np.asarray([n], np.int32),
                     "pos0": np.asarray([start], np.int32)}
            seed = None
            if part.done == 0:
                seed, part.seed = part.seed, None
                # per-request constant extras (encdec's encoder memory) ride
                # the FIRST chunk only: the encoder runs once and its cross
                # K/V persists in the accumulating sub-cache
                for k, v in (part.req.extras or {}).items():
                    batch[k] = np.asarray(v)[None]
            self.stats["prefill_tokens"] += n
            self.stats["prefill_chunks"] += 1
            part.done += n
            self.obs.request_event(part.req.rid, "prefill_chunk",
                                   done=part.done)
            final = start + n >= len(toks)
            steps.append(_PartStep(part=part, batch=batch, final=final,
                                   seed=seed))
            if not final:
                still.append(part)
                continue
            spec = self._effective_spec(part.req)
            if part.plan is not None:
                self.lane_pages[part.lane] = (part.plan.shared
                                              + part.plan.swapped
                                              + part.plan.new)
                self._register_prefix(part.req, part.plan)
            self._lane_pending[part.lane] = False
            self._lane_stoch[part.lane] = self._is_stochastic(spec)
            self._round_admitted.append(part.lane)
            t = time.perf_counter() if t is None else t
            self.req_times[part.req.rid]["first_token"] = t
            self._ttft_hist.record(self.now - part.req.arrival)
            self.obs.request_event(part.req.rid, "admitted",
                                   lane=part.lane, chunked=True)
            self.obs.request_event(part.req.rid, "first_token")
        self._partials = still
        return steps

    def _advance_partials(self):
        """Unfused executor: run each planned chunk as its own prefill call,
        splicing those that finish."""
        eng = self.engine
        for s in self._plan_partial_steps():
            if s.seed is not None:
                s.part.sub_cache = eng._seed_pages(
                    self.cache, s.part.sub_cache, s.seed[0], s.seed[1],
                    self.max_len)
            self.stats["dispatches"] += 1
            with self.obs.span("prefill_chunk", dispatch=True,
                               rid=s.part.req.rid, final=s.final):
                logits, s.part.sub_cache = eng._prefill(
                    eng.params, s.batch, s.part.sub_cache)
            if s.final:
                self._splice_partial(s.part, logits)

    def _assemble_parts(self, steps: list[_PartStep]):
        """Turn planned partial chunks into the fused step's ``parts`` input
        (host arrays + static final/stochastic flags).  Final chunks carry
        their splice data: target lane, budget, sampler row and — under
        paging — their page-copy plan."""
        parts, finals, stochs = [], [], []
        for s in steps:
            d = {"batch": dict(s.batch), "cache": s.part.sub_cache}
            if s.seed is not None:
                d["seed_tab"], d["seed_len"] = s.seed
            stoch = False
            if s.final:
                spec = self._effective_spec(s.part.req)
                stoch = self._is_stochastic(spec)
                d["sub_state"] = S.lane_state([spec], 1, device=self.device)
                d["lane"] = np.asarray([s.part.lane], np.int32)
                d["budget"] = np.asarray([s.part.budget], np.int32)
                if self.page_size is not None:
                    rows, cols, dsts, tab = self._page_copy_plan(
                        [s.part.plan])
                    d["copy_rows"] = np.asarray(rows, dtype=np.int32)
                    d["copy_cols"] = np.asarray(cols, dtype=np.int32)
                    d["copy_dsts"] = np.asarray(dsts, dtype=np.int32)
                    d["tab_rows"] = np.asarray(tab)
            parts.append(d)
            finals.append(s.final)
            stochs.append(stoch)
        return tuple(parts), tuple(finals), tuple(stochs)

    def _splice_partial(self, part: _Partial, logits):
        """Final chunk done: sample the first token from its logits, copy
        pages / splice the accumulated sub-cache into the reserved lane, and
        activate it — the single-request mirror of ``_admit``'s tail."""
        eng = self.engine
        dev = self.device
        req = part.req
        spec = self._effective_spec(req)
        sub_state = S.lane_state([spec], 1, device=dev)
        if self._is_stochastic(spec):
            first_tok, sub_state = eng._sample(logits, sub_state)
        else:
            first_tok = eng._sample(logits)
        lane = part.lane
        lanes = np.asarray([lane])
        if self.page_size is not None:
            self._copy_pages(part.sub_cache, [part.plan], lanes)
            self._register_prefix(req, part.plan)
        lane_idx = torch.as_tensor(lanes, dtype=torch.int64, device=dev)
        self.cache = eng.slot_update(self.cache, lane_idx, part.sub_cache)
        self.sstate = S.slot_update(self.sstate, lane_idx, sub_state)
        budget = int(part.budget)
        self.tok = P.set_lanes(self.tok, lane_idx, first_tok)
        seeds = torch.zeros((1, self.out_buf.shape[1]), dtype=torch.int32,
                            device=dev)
        seeds[:, 0] = first_tok
        self.out_buf = P.set_lanes(self.out_buf, lane_idx, seeds)
        self.n_gen = P.set_lanes(self.n_gen, lane_idx, 1)
        self.budget = P.set_lanes(self.budget, lane_idx, budget)
        self.p = P.set_lanes(self.p, lane_idx,
                             (first_tok != eng.stop_token) & (budget > 1))
        self._lane_pending[lane] = False
        self._lane_stoch[lane] = self._is_stochastic(spec)

    # ------------------------------------------------------------------
    # paged admission plumbing
    # ------------------------------------------------------------------

    def _page_in(self, pages: list, entries: list):
        """Swap-in: scatter checksum-verified host-store ``entries`` into
        freshly allocated ``pages`` (one batched write, pid vector padded to
        a power of two aimed at the trash page).  The pages then seed the
        admission prefill exactly like resident shared pages; the host
        entries stay (content-addressed) for future hits."""
        with self.obs.span("swap_in", pages=len(pages)):
            kpad = _next_pow2(len(pages))
            pids = np.full((kpad,), self.trash_page, np.int32)
            pids[:len(pages)] = pages
            blocks = {}
            for pk, proto in entries[0].items():
                rows = [e[pk] for e in entries]
                rows += [np.zeros_like(proto)] * (kpad - len(rows))
                blocks[pk] = _to_device(np.stack(rows), self.cache[pk].dtype,
                                        self.device)
            self.stats["dispatches"] += 1
            self.stats["swap_in_pages"] += len(pages)
            self.cache = self.engine._scatter_blocks(
                self.cache, torch.as_tensor(pids, device=self.device), blocks)

    def _spill_pages(self, freed: list):
        """Dying-page exit: spill indexed pages to the host store (one
        batched gather; skipped for pages already stored under their prefix
        key), then drop them — and their subtrees — from the radix index."""
        if self.host_swap is not None:
            spill = []
            for pid in freed:
                pfx = self.prefix_index.prefix_of(pid)
                if pfx is not None and pfx not in self.host_swap:
                    spill.append((pid, pfx))
            if spill:
                with self.obs.span("swap_out", pages=len(spill)):
                    kpad = _next_pow2(len(spill))
                    pids = np.full((kpad,), self.trash_page, np.int32)
                    pids[:len(spill)] = [pid for pid, _ in spill]
                    self.stats["dispatches"] += 1
                    blocks = self.engine._gather_blocks(
                        self.cache, torch.as_tensor(pids, device=self.device))
                    blocks = self._block_on(blocks, "swap_out")
                    for i, (_, pfx) in enumerate(spill):
                        self.host_swap.put(pfx, {k: b[i].copy()
                                                 for k, b in blocks.items()})
                    self.stats["swap_out_pages"] += len(spill)
        for pid in freed:
            self.prefix_index.drop(pid)

    def _seed_arrays(self, plans, n_pad):
        """Seed table + per-row shared length for prefix-seeded admission
        (None when no plan shares anything).  Swapped-in pages seed exactly
        like resident shared pages — their content is in the pool by the
        time the seed gather runs (``_page_in`` writes at plan time)."""
        if not any(pl.shared or pl.swapped for pl in plans):
            return None
        ps = self.page_size
        seed_tab = np.zeros((n_pad, self.n_pages), np.int32)
        shared_len = np.zeros((n_pad,), np.int32)
        for i, pl in enumerate(plans):
            chain = pl.shared + pl.swapped
            seed_tab[i, :len(chain)] = chain
            shared_len[i] = len(chain) * ps
        return seed_tab, shared_len

    def _seed_shared_prefix(self, sub_cache, plans, n_pad):
        """Gather resident shared-prefix pages into the prefill sub-cache so
        suffix rows attend over the donor's K/V (positions [0, pos0))."""
        seed = self._seed_arrays(plans, n_pad)
        if seed is None:
            return sub_cache
        return self.engine._seed_pages(self.cache, sub_cache, seed[0],
                                       seed[1], self.max_len)

    def _page_copy_plan(self, plans):
        """Block-copy plan for freshly prefilled rows: (row, logical col,
        physical dst) triples plus the page-table rows to install (tail-
        padded with the lane's LAST private page so clamped out-of-budget
        writes from retired lanes can never touch a page another request
        owns)."""
        ps = self.page_size
        rows, cols, dsts = [], [], []
        tab_rows = np.zeros((len(plans), self.n_pages), np.int32)
        for i, pl in enumerate(plans):
            n_sh = len(pl.shared) + len(pl.swapped)   # seeded, not prefilled
            n_used = PG.pages_needed(pl.plen, ps)
            for j in range(n_sh, n_used):
                rows.append(i)
                cols.append(j)
                dsts.append(pl.new[j - n_sh])
            ids = pl.shared + pl.swapped + pl.new
            tab_rows[i, :len(ids)] = ids
            tab_rows[i, len(ids):] = pl.new[-1]
        return rows, cols, dsts, tab_rows

    def _copy_pages(self, sub_cache, plans, lanes):
        """Scatter-store freshly prefilled K/V blocks into their allocated
        pages and install the page-table rows (unfused executor)."""
        rows, cols, dsts, tab_rows = self._page_copy_plan(plans)
        ids = lambda x: np.asarray(x, np.int64)
        self.cache = self.engine._install_pages(
            self.cache, sub_cache, ids(rows), ids(cols), ids(dsts),
            torch.as_tensor(tab_rows, device=self.device),
            torch.as_tensor(np.asarray(lanes, np.int64), device=self.device))
        for i, pl in enumerate(plans):
            self.lane_pages[int(lanes[i])] = pl.shared + pl.swapped + pl.new

    def _register_prefix(self, req: Request, plan: _PagePlan):
        """Make this request's full prompt pages discoverable for sharing.
        Called at COMMIT time (the splice is riding this round's dispatch),
        never at plan time — a rolled-back plan must need no index surgery.
        Swapped-in pages register like fresh ones.  A request with extras
        (encdec's encoder memory) registers none: its decoder state depends
        on more than its prompt."""
        if not self.prefix_sharing or req.extras:
            return
        ps = self.page_size
        parent = plan.shared[-1] if plan.shared else -1
        ids = plan.shared + plan.swapped + plan.new
        for j in range(len(plan.shared), plan.plen // ps):
            self.prefix_index.register(
                parent, req.tokens[j * ps:(j + 1) * ps], ids[j],
                prefix=req.tokens[:(j + 1) * ps].tobytes())
            parent = ids[j]

    def _harvest(self):
        """Collect lanes whose request left the active partition (pending
        chunked-prefill lanes are reserved, not finished).  Its read of the
        device is the round's one wait for it (fused loop)."""
        with self.obs.span("harvest"):
            p_h, out_all, ngen_all = self._block_on(
                (self.p, self.out_buf, self.n_gen), "harvest")
            finished = np.flatnonzero((self.lane_rid >= 0) & ~p_h
                                      & ~self._lane_pending)
            if finished.size == 0:
                return
            self._retire_finished(finished, self.lane_rid, out_all, ngen_all)

    def _retire_finished(self, finished, lane_rid, out_all, ngen_all):
        """Record the results of the ``finished`` lanes (rids from the lane
        view ``lane_rid``, tokens and counts from host copies) and free
        their lanes and pages."""
        t = time.perf_counter()
        freed: list = []
        for lane in finished:
            lane = int(lane)
            rid = int(lane_rid[lane])
            n = int(ngen_all[lane])
            reason = (FinishReason.PREEMPTED_RESUMED
                      if self._rid_preempts.get(rid) else FinishReason.DONE)
            self.results[rid] = {"tokens": out_all[lane, :n].copy(),
                                 "n_generated": n,
                                 "finished_at": self.now,
                                 "finish_reason": reason}
            self.req_times[rid]["finished"] = t
            self._live_req.pop(rid, None)
            self.obs.request_end(rid, n_generated=n, finished_at=self.now,
                                 reason=reason.value)
            self.lane_rid[lane] = -1
            self._lane_stoch[lane] = False
            if self.page_size is not None:
                for pid in self.lane_pages.pop(lane):
                    if self.allocator.release(pid):
                        freed.append(pid)
        if self.page_size is not None:
            if freed:
                self._spill_pages(freed)
            # retired lanes keep decoding architecturally until their slot
            # is refilled: repoint their table rows at the trash page (a new
            # tensor; the next burst copies it into the graphs' carry) so
            # the freed pages can be reused
            self.cache["page_table"] = P.set_lanes(
                self.cache["page_table"],
                torch.as_tensor(finished, dtype=torch.int64,
                                device=self.device),
                self.trash_page)

    def _maybe_compact(self):
        """SVE ``compact`` over the lane vector: squeeze live lanes to the
        lowest indices when occupancy falls below the threshold."""
        if not self.queue:
            # lane density only pays off when admission is about to splice
            # into the tail; during a drain there is nothing to buy with a
            # whole-cache gather
            return
        occupied = self.lane_rid >= 0
        occ = occupied.sum() / self.capacity
        if occ >= self.compact_threshold or self.compact_threshold <= 0:
            return
        if not occupied.any():
            return
        # already dense at the front? nothing to move
        n_live = int(occupied.sum())
        if occupied[:n_live].all():
            return
        with self.obs.span("compact", live=n_live):
            self._compact(occupied)

    def _compact(self, occupied):
        # the SVE compact permutation computed host-side — a stable argsort
        # of the inactive flag — so deciding to compact never waits for the
        # device
        perm = np.argsort(~occupied, kind="stable")
        dev = self.device
        perm_idx = torch.as_tensor(perm, dtype=torch.int64, device=dev)
        take = lambda t: t.index_select(0, perm_idx)
        # on a paged cache this moves page-table ROWS only — the pools never
        # move, so compaction cost is O(n_pages), not O(cache)
        self.cache = self.engine.gather_lanes(self.cache, perm_idx)
        self.sstate = S.gather_lanes(self.sstate, perm_idx)
        self.out_buf = take(self.out_buf)
        self.tok = take(self.tok)
        self.p = take(self.p) & torch.as_tensor(occupied[perm], device=dev)
        self.n_gen = take(self.n_gen)
        self.budget = take(self.budget)
        self.lane_rid = self.lane_rid[perm]
        self._lane_stoch = self._lane_stoch[perm]
        self._lane_pending = self._lane_pending[perm]
        self._host_ngen = self._host_ngen[perm]
        new_of = {int(old): new for new, old in enumerate(perm)}
        for part in self._partials:
            part.lane = new_of[part.lane]
        if self.page_size is not None:
            self.lane_pages = {new: self.lane_pages[int(old)]
                               for new, old in enumerate(perm)
                               if int(old) in self.lane_pages}
        if self._stash is not None:
            # the in-flight round's copies describe the OLD lane order:
            # the harvest permutes them when they land, and the snapshot
            # views move now, so the delayed harvest reads a coherent
            # picture
            st = self._stash
            st["perm"] = st["perm"][perm] if "perm" in st else perm
            st["lane_rid"] = st["lane_rid"][perm]
            st["pending"] = st["pending"][perm]
            st["admitted"] = [new_of[l] for l in st["admitted"]]
        self.stats["compactions"] += 1
