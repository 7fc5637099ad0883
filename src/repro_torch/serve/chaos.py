"""Deterministic fault injection for the serving stack (the chaos harness),
as in ``repro.serve.chaos``, over the port's ``ContinuousBatchingScheduler``.

The paper's first-faulting loads (§2.5.2) turn a mid-vector fault into
partial progress plus resume instead of failure; this module is the traffic
analogue — inject the faults a production serving system actually sees and
assert the scheduler degrades the same way: partial progress, bit-exact
state, never a leak and never wrong tokens.

Everything is driven by ONE seeded ``numpy.random.RandomState``, so a chaos
schedule is a pure function of ``ChaosConfig.seed`` — a failing soak run
replays exactly from its config.  Three injection points:

* ``PageAllocator.alloc`` fails on schedule (returns None as if the pool
  were exhausted) — exercises admission back-off, ``page_waits`` and the
  preemption/resume retry path.
* ``HostSwapStore.put`` flips one byte in the stored entry AFTER its CRC was
  taken — the next ``get`` must detect the mismatch, drop the entry and
  degrade that request to a cold prefill (``swap_checksum_failures``),
  never serve corrupt K/V.
* ``on_round`` cancels random live requests between scheduler rounds —
  exercises every branch of ``cancel`` (queued / preempted / pending /
  resident).

``ChaosMonkey.run`` drives a scheduler to drain with per-round injection;
``burst_trace`` builds clustered-arrival overload traces.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """One deterministic fault schedule.  Rates are per-opportunity
    probabilities (per ``alloc`` call / per ``put`` / per live request per
    round); ``burst_arrivals`` is the cluster size ``burst_trace`` emits at
    each arrival instant (0 = smooth one-at-a-time arrivals)."""
    seed: int = 0
    alloc_fail_rate: float = 0.0
    swap_corrupt_rate: float = 0.0
    cancel_rate: float = 0.0
    burst_arrivals: int = 0


class ChaosMonkey:
    """Installable fault injector around one scheduler.

    ``install`` wraps the scheduler's allocator / swap store in place (the
    wrappers call through to the originals, so allocator invariants keep
    holding — a chaotic failure is indistinguishable from a genuinely full
    pool).  Injection counts land on the instance (``alloc_failures``,
    ``corruptions``, ``cancels``) so a soak test can assert the schedule
    actually fired.
    """

    def __init__(self, config: ChaosConfig):
        self.config = config
        self.rng = np.random.RandomState(config.seed)
        self.alloc_failures = 0
        self.corruptions = 0
        self.cancels = 0

    def install(self, sched) -> "ChaosMonkey":
        cfg = self.config
        if cfg.alloc_fail_rate > 0 and getattr(sched, "page_size", None) \
                is not None:
            allocator = sched.allocator
            inner_alloc = allocator.alloc

            def chaotic_alloc(n: int):
                if n > 0 and self.rng.random_sample() < cfg.alloc_fail_rate:
                    self.alloc_failures += 1
                    return None
                return inner_alloc(n)

            allocator.alloc = chaotic_alloc
        if cfg.swap_corrupt_rate > 0 and getattr(sched, "host_swap",
                                                 None) is not None:
            store = sched.host_swap
            inner_put = store.put

            def chaotic_put(key: bytes, entry: dict):
                fresh = key not in store
                inner_put(key, entry)
                # corrupt AFTER the CRC was taken, and only entries this put
                # actually inserted — the flip models host memory rotting
                # under the store, which the next get must catch
                if fresh and key in store._store \
                        and self.rng.random_sample() < cfg.swap_corrupt_rate:
                    ent = store._store[key]
                    pk = sorted(ent)[self.rng.randint(len(ent))]
                    # numpy views of device arrays are read-only: corrupt an
                    # owned copy and swap it into the entry
                    b = np.array(ent[pk])
                    flat = b.view(np.uint8).reshape(-1)
                    flat[self.rng.randint(flat.size)] ^= 0xFF
                    ent[pk] = b
                    self.corruptions += 1

            store.put = chaotic_put
        return self

    def on_round(self, sched):
        """Between-round injection: cancel each live request with
        probability ``cancel_rate`` (deterministic in submission order)."""
        if self.config.cancel_rate <= 0:
            return
        for rid in sorted(sched._live_req):
            if self.rng.random_sample() < self.config.cancel_rate:
                if sched.cancel(rid):
                    self.cancels += 1

    def run(self, sched) -> dict:
        """Drive ``sched`` to drain with per-round injection; returns its
        results dict (same contract as ``scheduler.run``)."""
        while (sched.queue or sched._preempted
               or (sched.lane_rid >= 0).any()):
            sched.step()
            self.on_round(sched)
        sched._flush_stash()
        return sched.results


def burst_trace(n_requests: int, *, prompt_len: int, vocab: int,
                burst: int = 0, gap: float = 4.0, seed: int = 0,
                priority_of=None) -> list:
    """Clustered-arrival overload trace: ``n_requests`` random prompts
    arriving ``burst`` at a time (every ``gap`` decode steps); ``burst=0``
    spaces them one per instant.  Returns ``[{"tokens", "arrival",
    "priority"}, ...]`` ready to feed ``submit``; ``priority_of(i)`` maps
    request index to priority (default all 0)."""
    rng = np.random.RandomState(seed)
    group = burst if burst > 0 else 1
    reqs = []
    for i in range(n_requests):
        reqs.append({
            "tokens": rng.randint(1, vocab, size=(prompt_len,)).astype(
                np.int32),
            "arrival": float((i // group) * gap),
            "priority": int(priority_of(i)) if priority_of else 0,
        })
    return reqs
