"""Serving launcher of the port: bring up a ServeEngine for an arch and push
a stream of ragged requests through the continuous-batching scheduler (the
default), or one static batch through ``ServeEngine.generate`` with
``--static``.

    python -m repro_torch.launch.serve --arch stablelm_3b
    python -m repro_torch.launch.serve --arch stablelm_3b --page-size 16 \
        --host-swap-pages 64 --prefill-chunk 8
    python -m repro_torch.launch.serve --arch zamba2_1_2b --page-size 16 \
        --page-dtype int8 --prefill-chunk 16
    python -m repro_torch.launch.serve --arch stablelm_3b --static --no-reduce
    python -m repro_torch.launch.serve --arch seamless_m4t_large_v2 \
        --src-len 16 --page-size 4 --prefill-chunk 8
    python -m repro_torch.launch.serve --arch llama_3_2_vision_11b --static
    python -m repro_torch.launch.serve --arch stablelm_3b --device cpu \
        --temperature 0.8 --top-p 0.9 --trace-out trace.json --metrics
    python -m repro_torch.launch.serve --arch stablelm_3b --device cpu \
        --page-size 4 --pool-pages 12 --overlap --priority-every 3 \
        --max-queue 6 --deadline-steps 40 --chaos-seed 1 \
        --chaos-alloc-fail-rate 0.2 --chaos-cancel-rate 0.05

Dims are reduced by default, as in ``repro.launch.serve``; ``--no-reduce``
runs the published widths.  ``--batch`` is the scheduler's lane capacity
(the batch size with ``--static``).  ``--page-dtype int8|fp8`` stores the
paged cache's pools narrow and needs ``--page-size``.  ``--temperature``
turns on stochastic sampling for every request (request i uses seed
``--sample-seed`` + i); without it decoding is greedy.  ``--overlap`` runs
the async host loop; ``--max-queue``, ``--deadline-steps``,
``--priority-every`` and ``--chaos-*`` drive the request control plane and
the chaos harness (``serve.chaos``), with the JAX launcher's meaning, and a
``[robustness]`` line reports them.  An encdec arch streams each request
with its own random encoder input (``--src-len`` frames at most, default
``--prompt-len``); the VLM arch serves one static batch with random image
embeddings, as the JAX launcher does.  Every arch of ``repro.configs`` is
served (stablelm-12b with its head dim of 160).  What is not ported yet
exits naming the ROADMAP item that ports it: ``--mesh`` (Queue 1 item 14).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.configs import all_arch_names, get_config
from repro_torch.core.device import resolve_device
from repro_torch.launch.train import reduced
from repro_torch.models import get_model
from repro_torch.obs import Obs, Tracer
from repro_torch.sample import SamplingParams
from repro_torch.serve import ContinuousBatchingScheduler, ServeEngine
from repro_torch.serve.chaos import ChaosConfig, ChaosMonkey

# the JAX launcher's options that are not ported yet -> (flag, ROADMAP item)
PENDING_OPTIONS = (
    ("mesh", "--mesh", "Queue 1 item 14 (mesh-sharded serving)"),
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--reduce", action=argparse.BooleanOptionalAction,
                    default=True, help="shrink dims (default); --no-reduce "
                    "runs the published widths")
    ap.add_argument("--batch", type=int, default=4,
                    help="lane capacity (scheduler) / batch size (--static)")
    ap.add_argument("--requests", type=int, default=10,
                    help="number of streamed requests (scheduler mode)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=4,
                    help="decode steps between admission opportunities")
    ap.add_argument("--compact-threshold", type=float, default=0.5)
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per KV page; enables the paged cache "
                         "(admission gated on page availability)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="physical pages in the pool (default: the dense "
                         "footprint, capacity * pages-per-lane)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable prompt-prefix page sharing under --page-size")
    ap.add_argument("--host-swap-pages", type=int, default=None,
                    help="host-side LRU swap store capacity in pages: shared-"
                         "prefix pages spill to host on eviction and page "
                         "back in on a later prompt hit (requires "
                         "--page-size)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="split admission prefill into chunks of this many "
                         "tokens interleaved with decode rounds (ssm/hybrid: "
                         "a multiple of ssm_chunk)")
    ap.add_argument("--paged-attn", choices=["native", "gather"],
                    default="native")
    ap.add_argument("--no-fused", action="store_true",
                    help="run the unfused host loop (separate prefill and "
                         "burst calls) instead of the fused step")
    ap.add_argument("--static", action="store_true",
                    help="one-shot ServeEngine.generate instead of the "
                         "scheduler (always for the vlm arch)")
    ap.add_argument("--src-len", type=int, default=None,
                    help="encdec: padded encoder memory length the scheduler "
                         "allocates caches for (default: --prompt-len)")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="record the serve run's round/request timeline and "
                         "export Chrome/Perfetto trace_event JSON to FILE; "
                         "served tokens and dispatch/sync counts are "
                         "unchanged by tracing")
    ap.add_argument("--metrics", action="store_true",
                    help="print the obs registry snapshot after the run")
    ap.add_argument("--overlap", action="store_true",
                    help="async host loop: dispatch round N+1 before reading "
                         "round N (one blocking sync per round)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission queue: submits past this many "
                         "queued requests are SHED (typed partial result) "
                         "instead of queueing unboundedly")
    ap.add_argument("--deadline-steps", type=float, default=None,
                    help="per-request completion deadline, in decode steps "
                         "after arrival: a request still decoding past it "
                         "retires with its partial output "
                         "(finish_reason='deadline')")
    ap.add_argument("--priority-every", type=int, default=0,
                    help="mark every Nth request priority 5 (0 disables): "
                         "under page/lane starvation high-priority arrivals "
                         "preempt a lower-priority lane and the victim later "
                         "resumes bit for bit")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="install a deterministic ChaosMonkey with this "
                         "seed (requires --chaos-* rates below to do "
                         "anything)")
    ap.add_argument("--chaos-alloc-fail-rate", type=float, default=0.0,
                    help="probability each page allocation spuriously fails "
                         "(models transient pool pressure)")
    ap.add_argument("--chaos-cancel-rate", type=float, default=0.0,
                    help="per-round probability each live request is "
                         "cancelled (exercises every cancel branch)")
    ap.add_argument("--chaos-swap-corrupt-rate", type=float, default=0.0,
                    help="probability a host-swap insert is byte-flipped "
                         "after its CRC — the next hit must degrade to a "
                         "cold prefill, never serve corrupt K/V")
    # the JAX launcher's options still to port (PENDING_OPTIONS): each exits
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to opt out)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--page-dtype", choices=["int8", "fp8"], default=None)
    ap.add_argument("--temperature", type=float, default=None,
                    help="enable per-request stochastic sampling at this "
                         "temperature (default: greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k vocab filtering (0 disables)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus filtering mass (1.0 disables)")
    ap.add_argument("--min-p", type=float, default=0.0,
                    help="min-p filtering (0 disables)")
    ap.add_argument("--repetition-penalty", type=float, default=1.0)
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="base sampling seed; request i uses seed+i, so "
                         "every stream is reproducible per request")
    args = ap.parse_args(argv)

    if args.arch not in all_arch_names():
        ap.error(f"unknown arch {args.arch!r}")
    for dest, flag, item in PENDING_OPTIONS:
        if getattr(args, dest) not in (None, False):
            sys.exit(f"{flag} is not ported yet: ROADMAP {item}")
    if args.page_dtype is not None and args.page_size is None:
        ap.error("--page-dtype requires --page-size (quantization lives in "
                 "the page pools)")
    if args.host_swap_pages is not None and args.page_size is None:
        ap.error("--host-swap-pages requires --page-size (the swap tier "
                 "moves pages)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = get_model(cfg).init(cfg, gen, device)
    rng = np.random.RandomState(args.seed)
    batch = {"tokens": rng.randint(1, cfg.vocab_size,
                                   (args.batch, args.prompt_len)),
             "lens": rng.randint(4, args.prompt_len + 1, args.batch)}
    if cfg.cross_attn_group:
        batch["cross_emb"] = rng.randn(
            args.batch, cfg.n_cross_tokens, cfg.d_model).astype(np.float32)
    if cfg.family == "encdec":
        batch["src_emb"] = rng.randn(
            args.batch, args.prompt_len, cfg.d_model).astype(np.float32)
        batch["src_lens"] = np.full((args.batch,), args.prompt_len, np.int32)
    obs = Obs(tracer=Tracer() if args.trace_out else None)
    eng = ServeEngine(cfg, params, max_new_tokens=args.max_new, stop_token=7,
                      paged_attn=args.paged_attn, page_dtype=args.page_dtype,
                      device=device, obs=obs)

    def _sampling(i: int):
        """Per-request SamplingParams (None = greedy) for request index i."""
        if args.temperature is None:
            return None
        return SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p, min_p=args.min_p,
                              repetition_penalty=args.repetition_penalty,
                              seed=args.sample_seed + i, greedy=False)

    if args.static or cfg.cross_attn_group:
        # the vlm's image embeddings are per batch, not per request
        sampling = ([_sampling(i) for i in range(args.batch)]
                    if args.temperature is not None else None)
        res = eng.generate(batch, sampling=sampling, page_size=args.page_size)
        for i in range(args.batch):
            n = int(res["n_generated"][i])
            print(f"req{i} len={int(batch['lens'][i]):2d} -> "
                  f"{res['tokens'][i, :n].tolist()}")
        _finish_obs(args, obs)
        return

    # ---- continuous batching: stream requests through the lane vector ----
    src_len = ((args.src_len or args.prompt_len)
               if cfg.family == "encdec" else None)
    sched = ContinuousBatchingScheduler(
        eng, capacity=args.batch, max_len=args.prompt_len + args.max_new,
        chunk=args.chunk, compact_threshold=args.compact_threshold,
        page_size=args.page_size, pool_pages=args.pool_pages,
        prefix_sharing=not args.no_prefix_sharing,
        host_swap_pages=args.host_swap_pages,
        prefill_chunk=args.prefill_chunk, fused=not args.no_fused,
        overlap=args.overlap, src_len=src_len, max_queue=args.max_queue,
        obs=obs)
    monkey = None
    if args.chaos_seed is not None:
        monkey = ChaosMonkey(ChaosConfig(
            seed=args.chaos_seed,
            alloc_fail_rate=args.chaos_alloc_fail_rate,
            cancel_rate=args.chaos_cancel_rate,
            swap_corrupt_rate=args.chaos_swap_corrupt_rate)).install(sched)
    rid_len = {}
    for i in range(args.requests):
        plen = int(rng.randint(4, args.prompt_len + 1))
        extras = None
        if cfg.family == "encdec":
            sl = int(rng.randint(2, src_len + 1))
            extras = {"src_emb": rng.randn(sl, cfg.d_model)
                      .astype(np.float32)}
        prio = (5 if args.priority_every and i % args.priority_every == 0
                else 0)
        rid = sched.submit(rng.randint(1, cfg.vocab_size, plen),
                           sampling=_sampling(i), extras=extras, priority=prio,
                           deadline=(args.deadline_steps
                                     if args.deadline_steps else None))
        rid_len[rid] = plen
    results = monkey.run(sched) if monkey else sched.run()
    for rid in sorted(results):
        r = results[rid]
        print(f"req{rid} len={rid_len[rid]:2d} "
              f"[{r['finish_reason'].value}] -> {r['tokens'].tolist()}")
    st = sched.stats
    occ = st["occupancy_trace"]
    print(f"[scheduler] rounds={st['steps']} dispatches={st['dispatches']} "
          f"host syncs={st['host_syncs']} compactions={st['compactions']} "
          f"mean occupancy={sum(occ) / max(len(occ), 1):.2f}"
          + (f"  prefill chunks={st['prefill_chunks']}"
             if args.prefill_chunk else ""))
    if (st["preemptions"] or st["cancelled"] or st["shed"]
            or st["deadline_misses"] or monkey):
        print(f"[robustness] preemptions={st['preemptions']} "
              f"(pages back in={st['resume_page_ins']})  "
              f"cancelled={st['cancelled']}  shed={st['shed']}  "
              f"deadline misses={st['deadline_misses']}"
              + (f"  [chaos seed={args.chaos_seed}: "
                 f"alloc fails={monkey.alloc_failures} "
                 f"cancels={monkey.cancels} "
                 f"corruptions={monkey.corruptions}]" if monkey else ""))
    if args.page_size is not None:
        pocc = st["page_occupancy_trace"]
        print(f"[paged] pool={sched.pool_pages} pages "
              f"(page_size={args.page_size})  "
              f"mean pool occupancy={sum(pocc) / max(len(pocc), 1):.2f}  "
              f"prefix hits={st['prefix_hits']} "
              f"({st['prefix_hit_tokens']} tokens skipped)  "
              f"page waits={st['page_waits']}"
              + (f"  page_dtype={args.page_dtype}" if args.page_dtype
                 else ""))
        if args.host_swap_pages:
            print(f"[swap] session hits={st['session_hits']} "
                  f"({st['session_hit_tokens']} tokens skipped)  "
                  f"out={st['swap_out_pages']} in={st['swap_in_pages']} pages  "
                  f"store={len(sched.host_swap)}/{args.host_swap_pages}  "
                  f"checksum failures={st['swap_checksum_failures']}")
    _finish_obs(args, obs)


def _finish_obs(args, obs):
    """Export the trace / print the metrics snapshot per the CLI flags."""
    if args.trace_out:
        n = obs.export(args.trace_out)
        print(f"[obs] wrote {n} trace events to {args.trace_out} "
              "(open in ui.perfetto.dev or chrome://tracing)")
    if args.metrics:
        print("[obs] " + json.dumps(obs.metrics.snapshot(), indent=2,
                                    sort_keys=True))


if __name__ == "__main__":
    main()
