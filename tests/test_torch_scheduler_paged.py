"""Port parity of the scheduler's paged cache against the JAX scheduler:
the page structures (``PageAllocator``, ``PrefixIndex``, ``HostSwapStore``
and ``_entry_crc``) end in the same state after one seeded random schedule,
and one trace with every paged feature on — prefix sharing, the host-swap
tier (an LRU of 4 pages, so it evicts), chunked prefill, page waits and
compaction, mixed greedy and stochastic requests — serves each rid the same
bytes with equal stats, leaking no page.  Within the port: a multi-turn
session pages its prefix back in and serves the bytes a cold prefill
serves, and int8 / fp8 pages admit through ``_install_pages`` to the tokens
of ``generate`` of each request alone on the same pages."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
from torch_parity import (assert_same_results,
                          jax_scheduler_seeding_swapped_pages, plain_models,
                          sched_trace, serve_trace)

from repro.serve import ContinuousBatchingScheduler as JaxScheduler
from repro.serve import SamplingParams as JaxSampling
from repro.serve import ServeEngine as JaxEngine
from repro.serve import scheduler as SJ
from repro_torch.serve import (ContinuousBatchingScheduler, SamplingParams,
                               ServeEngine)
from repro_torch.serve import scheduler as ST

MAX_LEN = 24
PAGED = dict(chunk=3, page_size=4, pool_pages=14, prefill_chunk=4,
             host_swap_pages=4)


def _schedule(mod, seed=0, n_ops=400):
    """One seeded random schedule over one package's page structures, with
    the allocator's invariants held after every op."""
    rng = np.random.RandomState(seed)
    alloc, index, store = (mod.PageAllocator(12), mod.PrefixIndex(),
                           mod.HostSwapStore(5))
    held: list = []
    crcs: list = []
    for _ in range(n_ops):
        op = rng.randint(8)
        if op == 0:
            pages = alloc.alloc(int(rng.randint(1, 4)))
            if pages is not None:
                held += pages
        elif op == 1 and held:
            p = held[rng.randint(len(held))]
            alloc.retain(p)
            held.append(p)
        elif op == 2 and held:
            p = held.pop(rng.randint(len(held)))
            if alloc.release(p):
                index.drop(p)
        elif op == 3 and held:
            parent = int(rng.randint(-1, 12))
            block = rng.randint(1, 6, 2).astype(np.int32)
            page = held[rng.randint(len(held))]
            index.register(parent, block, page, prefix=block.tobytes()
                           + bytes([parent % 256]))
        elif op == 4:
            index.lookup(rng.randint(1, 6, 8).astype(np.int32), 2)
        elif op == 5:
            key = bytes([rng.randint(6)])
            entry = {"k_pages": rng.randn(2, 4).astype(np.float32),
                     "k_pages_scale": rng.randint(-5, 5, 3).astype(np.int8)}
            store.put(key, entry)
            crcs.append(mod._entry_crc(entry))
        elif op == 6:
            key = bytes([rng.randint(6)])
            if key in store and rng.rand() < 0.2:     # corrupt it in place
                store._store[key]["k_pages"][0, 0] += 1.0
            store.get(key)
        elif op == 7 and held:
            index.drop(held[rng.randint(len(held))])
        assert alloc.free_pages + alloc.live_pages == alloc.pool_pages
        assert (alloc.refcount >= 0).all()
        assert sorted(set(alloc._free)) == sorted(alloc._free)
        assert all(alloc.refcount[p] == 0 for p in alloc._free)
    state = dict(free=list(alloc._free), refcount=alloc.refcount.tolist(),
                 child=dict(index._child), key_of=dict(index._key_of),
                 kids={k: sorted(v) for k, v in index._kids.items() if v},
                 prefix_of=dict(index._prefix_of), n_index=len(index),
                 store=list(store._store), crc=dict(store._crc),
                 evictions=store.evictions, failures=store.checksum_failures,
                 crcs=crcs)
    return state, alloc


def test_page_structures_end_in_the_same_state():
    want, _ = _schedule(SJ)
    got, alloc = _schedule(ST)
    assert got == want
    assert want["evictions"] > 0 and want["failures"] > 0 and want["crcs"]
    held = [p for p in range(alloc.pool_pages) if alloc.refcount[p] > 0]
    for p in held:                       # release to zero: never a leak
        while not alloc.release(p):
            pass
    assert alloc.live_pages == 0
    with pytest.raises(ValueError, match="double free"):
        alloc.release(0)
    with pytest.raises(ValueError, match="retain of free page"):
        alloc.retain(0)
    assert alloc.alloc(13) is None and alloc.free_pages == 12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_entry_crc_is_over_the_pool_bytes(dtype):
    """A swapped entry's CRC is taken over the same bytes in both packages:
    a bf16 pool's block spills as its bits."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 3).astype(np.float32)
    if dtype == "int8":
        x = rng.randint(-100, 100, (2, 4, 3)).astype(np.int8)
    j = np.asarray(jnp.asarray(x, dtype))
    t = ST._to_host(torch.from_numpy(x).to(getattr(torch, dtype)))
    entry_j = {"v_pages": j, "k_pages": j[::-1]}
    entry_t = {"v_pages": t, "k_pages": t[::-1]}
    assert ST._entry_crc(entry_t) == SJ._entry_crc(entry_j)
    back = ST._to_device(t, getattr(torch, dtype), "cpu")
    assert torch.equal(back, torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.fixture(scope="module")
def paged_trace():
    """The trace of the JAX package's paged + prefix + chunked + compacting
    fused test, with the host-swap tier, through the JAX scheduler once,
    then with ``overlap=True`` on the same JAX engine (its
    chunked requests seeded from paged-in prefix pages too: three of them
    take that path, ``jax_scheduler_seeding_swapped_pages``)."""
    cfg_j, params, cfg_t, model = plain_models(1)
    rng = np.random.RandomState(12)
    trace = sched_trace(rng, 10, shared_prefix=rng.randint(1, 64, 8))
    eng_j = JaxEngine(cfg_j, params, max_new_tokens=6, stop_token=7)
    want, stats, _ = serve_trace(jax_scheduler_seeding_swapped_pages(),
                                 JaxSampling, eng_j, trace, max_len=MAX_LEN,
                                 **PAGED)
    over = serve_trace(jax_scheduler_seeding_swapped_pages(), JaxSampling,
                       eng_j, trace, max_len=MAX_LEN, overlap=True, **PAGED)
    eng_t = ServeEngine(cfg_t, model, max_new_tokens=6, stop_token=7,
                        device="cpu")
    return eng_t, trace, want, stats, over[:2]


@pytest.mark.parametrize("fused", [True, False])
def test_paged_prefix_swap_chunked_trace_matches_jax(paged_trace, fused):
    """Fused: the JAX scheduler's bytes and stats.  Unfused: the same bytes
    (the JAX package holds its own fused == unfused)."""
    eng_t, trace, want, want_stats, _ = paged_trace
    got, stats, sched = serve_trace(ContinuousBatchingScheduler,
                                    SamplingParams, eng_t, trace,
                                    max_len=MAX_LEN, fused=fused, **PAGED)
    assert_same_results(got, want, f"fused={fused}")
    if fused:
        assert stats == want_stats
    for k in ("prefix_hits", "session_hits", "swap_out_pages",
              "swap_in_pages", "prefill_chunks", "compactions", "page_waits"):
        assert stats[k] > 0, k
    assert stats["swap_checksum_failures"] == 0
    assert sched.allocator.live_pages == 0
    assert (sched.allocator.refcount == 0).all()
    assert len(sched.prefix_index) == 0 and len(sched.host_swap) <= 4
    assert (sched.cache["page_table"] == sched.trash_page).all()


def test_paged_overlap_trace_matches_jax(paged_trace):
    """The async overlap loop on the paged + prefix + swap + chunked +
    compacting trace: the JAX scheduler's ``overlap=True`` bytes and stats,
    every page back and every table row on the trash page."""
    eng_t, trace, _, _, (want, want_stats) = paged_trace
    got, stats, sched = serve_trace(ContinuousBatchingScheduler,
                                    SamplingParams, eng_t, trace,
                                    max_len=MAX_LEN, overlap=True, **PAGED)
    assert_same_results(got, want, "paged overlap")
    assert stats == want_stats
    for k in ("prefix_hits", "session_hits", "prefill_chunks", "compactions",
              "page_waits"):
        assert stats[k] > 0, k
    assert sched._stash is None and sched.allocator.live_pages == 0
    assert (sched.cache["page_table"] == sched.trash_page).all()


def test_multi_turn_session_pages_back_in():
    """Turn 2 of three conversations arrives after turn 1 retired (its
    prefix pages spilled to the host store), pages the prefix back in, and
    serves the bytes of a scheduler that never swapped."""
    _, _, cfg_t, model = plain_models()
    eng = ServeEngine(cfg_t, model, max_new_tokens=6, stop_token=7,
                      device="cpu")
    rng = np.random.RandomState(30)
    turn1 = [rng.randint(1, 64, 9) for _ in range(3)]
    turn2 = [np.concatenate([p, rng.randint(1, 64, 4)]) for p in turn1]

    def two_waves(host_swap_pages):
        sched = ContinuousBatchingScheduler(
            eng, capacity=4, max_len=MAX_LEN, chunk=4, page_size=4,
            host_swap_pages=host_swap_pages)
        for p in turn1:
            sched.submit(p)
        sched.run()
        rids = [sched.submit(p) for p in turn2]
        res = sched.run()
        return sched, [res[r]["tokens"].tobytes() for r in rids]

    warm_sched, warm = two_waves(64)
    cold_sched, cold = two_waves(None)
    assert warm == cold
    st = warm_sched.stats
    assert st["session_hits"] > 0 and st["swap_in_pages"] > 0
    assert st["session_hit_tokens"] >= st["session_hits"] * 4
    assert cold_sched.stats["session_hits"] == 0
    assert warm_sched.allocator.free_pages == warm_sched.pool_pages
    assert len(warm_sched.prefix_index) == 0


@pytest.mark.parametrize("page_dtype", ["int8", "fp8"])
def test_quantized_pages_admit_through_install_pages(page_dtype):
    """Admission truncates the prefilled K/V into int8 / fp8 pages
    (``_install_pages``' truncating store): each request through recycled
    lanes serves the tokens of ``generate`` of it alone, whose identity
    pages hold the same truncated bytes."""
    _, _, cfg_t, model = plain_models()
    eng = ServeEngine(cfg_t, model, max_new_tokens=6, stop_token=7,
                      device="cpu", page_dtype=page_dtype)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 64, rng.randint(4, 12)) for _ in range(6)]
    sched = ContinuousBatchingScheduler(eng, capacity=2, max_len=MAX_LEN,
                                        chunk=3, page_size=4)
    assert sched.cache["k_pages"].dtype == getattr(
        torch, {"int8": "int8", "fp8": "float8_e4m3fn"}[page_dtype])
    rids = [sched.submit(p) for p in prompts]
    results = sched.run()
    for rid, prompt in zip(rids, prompts):
        ref = eng.generate({"tokens": prompt[None]}, max_len=MAX_LEN,
                           page_size=4)
        n = int(ref["n_generated"][0])
        assert results[rid]["n_generated"] == n
        assert results[rid]["tokens"].tolist() == ref["tokens"][0, :n].tolist()
    assert sched.allocator.live_pages == 0
