"""Serving demo of the port: batched generation with vector-partitioned
early exit, continuous batching over a lane vector (SVE compact semantics),
per-lane heterogeneous sampling, and FFR-style speculative decoding,
batched per lane.

    python -m repro_torch.launch.serve_lm               # on the card
    python -m repro_torch.launch.serve_lm --device cpu  # plain versions

The counterpart of ``examples/serve_lm.py``, on the same tiny f32 models
(random weights from seeds 0 and 1, made by the port).  Where the JAX demo
holds its speculative tokens to greedy decoding by ``train_logits``, this
one holds them to the target's own greedy ``ServeEngine.generate``, and
raises if they differ.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import ModelConfig, get_model
from repro_torch.serve import (ContinuousBatchingScheduler, SamplingParams,
                               ServeEngine, speculative_decode)

BASE = dict(family="dense", param_dtype="float32", compute_dtype="float32",
            vocab_size=512)
TARGET = ModelConfig(name="target-20m", n_layers=4, d_model=256, n_heads=8,
                     n_kv_heads=4, d_ff=512, **BASE)
DRAFT = ModelConfig(name="draft-2m", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, d_ff=128, **BASE)


def _init(cfg, seed, device):
    return get_model(cfg).init(cfg, torch.Generator(device=device).manual_seed(seed),
                               device)


def _check(ok, what) -> None:
    if not ok:
        raise RuntimeError(what)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to opt out)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    tmodel, dmodel = _init(TARGET, 0, device), _init(DRAFT, 1, device)

    rng = np.random.RandomState(0)
    prompts = torch.from_numpy(rng.randint(1, 512, (4, 16))).to(device)
    lens = torch.tensor([16, 9, 12, 16], dtype=torch.int32, device=device)
    batch = {"tokens": prompts, "lens": lens}

    print("== batched generation, ragged prompts, early exit ==")
    eng = ServeEngine(TARGET, tmodel, max_new_tokens=8, stop_token=7,
                      device=device)
    res = eng.generate(batch)
    for i in range(4):
        n = int(res["n_generated"][i])
        print(f"  req{i} (len {int(lens[i]):2d}): "
              f"{res['tokens'][i, :n].tolist()}"
              f"{'  [stopped]' if not bool(res['active'][i]) else ''}")

    print("== continuous batching: 12 streamed requests over 4 lanes ==")
    sched = ContinuousBatchingScheduler(eng, capacity=4, max_len=28, chunk=4,
                                        compact_threshold=0.5)
    req_rng = np.random.RandomState(1)
    for i in range(12):
        plen = int(req_rng.randint(4, 17))
        sched.submit(req_rng.randint(1, 512, plen), arrival=float(i))
    results = sched.run()
    for rid in sorted(results):
        print(f"  req{rid}: {np.asarray(results[rid]['tokens']).tolist()}")
    occ = sched.stats["occupancy_trace"]
    print(f"  rounds={sched.stats['steps']} "
          f"compactions={sched.stats['compactions']} "
          f"mean occupancy={sum(occ) / max(len(occ), 1):.2f}")

    print("== per-lane heterogeneous sampling (one decode loop) ==")
    specs = [None,
             SamplingParams(temperature=1.0, top_p=0.9, seed=1, greedy=False),
             SamplingParams(temperature=0.7, top_k=8, seed=2, greedy=False),
             SamplingParams(temperature=0.9, repetition_penalty=1.3, seed=3,
                            greedy=False)]
    res_s = eng.generate(batch, sampling=specs)
    labels = ["greedy", "top_p=0.9", "top_k=8", "rep_pen=1.3"]
    for i in range(4):
        n = int(res_s["n_generated"][i])
        print(f"  lane{i} [{labels[i]:>10s}]: {res_s['tokens'][i, :n].tolist()}")
    _check(torch.equal(res_s["tokens"][0], res["tokens"][0]),
           "the greedy lane must equal the all-greedy engine's")
    rerun = eng.generate(batch, sampling=specs)
    _check(torch.equal(rerun["tokens"], res_s["tokens"]),
           "fixed seeds must repeat the streams")
    print("  greedy lane bit-identical + streams seed-reproducible: True")

    # target-alone greedy decoding, the FFR contract's reference
    alone = ServeEngine(TARGET, tmodel, max_new_tokens=12, stop_token=-1,
                        device=device)
    print("== speculative decoding (FFR acceptance) ==")
    out, stats = speculative_decode(TARGET, tmodel, DRAFT, dmodel, prompts[:1],
                                    n_tokens=12, k_draft=4)
    print(f"  tokens: {out.tolist()}")
    print(f"  accepted per round: {stats['accept_counts']} "
          f"(mean {stats['mean_accepted']:.2f} of k={stats['k_draft']})")
    want = alone.generate({"tokens": prompts[:1]})["tokens"][0]
    same = torch.equal(out, want.to(out.dtype))
    _check(same, "speculative tokens differ from target-alone greedy")
    print(f"  speculative tokens equal target-alone greedy generate: {same}")

    print("== batched speculative decoding (per-lane FFR partitions) ==")
    outs, bstats = speculative_decode(TARGET, tmodel, DRAFT, dmodel, prompts,
                                      n_tokens=8, k_draft=4, lens=lens)
    for i in range(outs.shape[0]):
        print(f"  lane{i}: {outs[i].tolist()}")
    print(f"  mean accepted across lanes: {bstats['mean_accepted']:.2f} "
          f"of k={bstats['k_draft']}")
    want = alone.generate(batch)["tokens"][:, :8]
    same = torch.equal(outs, want.to(outs.dtype))
    _check(same, "batched speculative tokens differ from target-alone greedy")
    print(f"  batched speculative tokens equal target-alone greedy generate: "
          f"{same}")

    print("== stochastic speculative decoding (rejection sampling) ==")
    # draft == target: q == p, so every proposal is accepted under
    # temperature sampling too (the rejection ratio is 1)
    sp = [SamplingParams(temperature=0.9, top_p=0.95, seed=10 + i, greedy=False)
          for i in range(4)]
    souts, sstats = speculative_decode(TARGET, tmodel, TARGET, tmodel, prompts,
                                       n_tokens=8, k_draft=3, lens=lens,
                                       sampling=sp)
    for i in range(souts.shape[0]):
        print(f"  lane{i}: {souts[i].tolist()}")
    print(f"  mean accepted with a perfect draft: {sstats['mean_accepted']:.2f} "
          f"of k={sstats['k_draft']} (rejection ratio p/q == 1)")


if __name__ == "__main__":
    main()
