"""Serving launcher of the port: bring up a ServeEngine for an arch and run
one static batch through ``ServeEngine.generate``.

    python -m repro_torch.launch.serve --arch stablelm_3b --static
    python -m repro_torch.launch.serve --arch stablelm_3b --static --no-reduce
    python -m repro_torch.launch.serve --arch zamba2_1_2b --static --page-size 16
    python -m repro_torch.launch.serve --arch olmoe_1b_7b --static \
        --page-size 16 --page-dtype int8
    python -m repro_torch.launch.serve --arch stablelm_3b --static \
        --temperature 0.8 --top-p 0.9 --device cpu

Dims are reduced by default, as in ``repro.launch.serve``; ``--no-reduce``
runs the published widths.  ``--page-dtype int8|fp8`` stores the paged
cache's pools narrow and needs ``--page-size``.  ``--temperature`` turns on
stochastic sampling for every request (request i uses seed
``--sample-seed`` + i); without it decoding is greedy.  The continuous-batching
scheduler (the JAX launcher's default mode) and ``--mesh`` are not ported
yet and exit naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import all_arch_names, get_config
from repro_torch.core.device import resolve_device
from repro_torch.models import get_model
from repro_torch.sample import SamplingParams
from repro_torch.serve import ServeEngine

# the reduced dims of repro.launch.train (training is not ported)
REDUCE = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=256, n_heads=4,
              n_kv_heads=2, head_dim=16, n_cross_tokens=16,
              param_dtype="float32", compute_dtype="float32")

# the JAX launcher's per-family extras on top of REDUCE
REDUCE_FAMILY = {
    "ssm": dict(ssm_state=16, ssm_headdim=16, ssm_chunk=16),
    "hybrid": dict(ssm_state=16, ssm_headdim=16, ssm_chunk=16, n_layers=5,
                   shared_attn_period=2),
    "moe": dict(n_experts=8, top_k=2, d_ff_dense=128),
}

# the JAX launcher's archs that the port cannot serve yet -> ROADMAP item
PENDING_ARCHS = {
    "llama_3_2_vision_11b": "Queue 1 item 12 (dense VLM branch)",
    "command_r_plus_104b": "a config module (dense family, not ported yet)",
    "stablelm_12b": "a config module (dense family, not ported yet)",
    "gemma3_27b": "a config module (dense family, not ported yet)",
    "seamless_m4t_large_v2": "Queue 1 item 12 (encdec)",
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--reduce", action=argparse.BooleanOptionalAction,
                    default=True, help="shrink dims (default); --no-reduce "
                    "runs the published widths")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per KV page: decode reads a paged cache")
    ap.add_argument("--paged-attn", choices=["native", "gather"],
                    default="native")
    ap.add_argument("--static", action="store_true",
                    help="one-shot ServeEngine.generate (the only mode so far)")
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

    if args.arch in PENDING_ARCHS:
        sys.exit(f"arch {args.arch} is not ported yet: ROADMAP "
                 f"{PENDING_ARCHS[args.arch]}")
    if args.arch not in all_arch_names():
        ap.error(f"unknown arch {args.arch!r}")
    if not args.static:
        sys.exit("the continuous-batching scheduler is not ported yet "
                 "(ROADMAP Queue 1 item 7); run with --static")
    if args.mesh is not None:
        sys.exit("mesh-sharded serving is not ported yet (ROADMAP Queue 1 item 14)")
    if args.page_dtype is not None and args.page_size is None:
        ap.error("--page-dtype requires --page-size (quantization lives in "
                 "the page pools)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = cfg.replace(**{**REDUCE, **REDUCE_FAMILY.get(cfg.family, {})})
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = get_model(cfg).init(cfg, gen, device)
    rng = np.random.RandomState(args.seed)
    batch = {"tokens": rng.randint(1, cfg.vocab_size,
                                   (args.batch, args.prompt_len)),
             "lens": rng.randint(4, args.prompt_len + 1, args.batch)}
    eng = ServeEngine(cfg, params, max_new_tokens=args.max_new, stop_token=7,
                      paged_attn=args.paged_attn, page_dtype=args.page_dtype,
                      device=device)
    sampling = None
    if args.temperature is not None:
        sampling = [SamplingParams(temperature=args.temperature,
                                   top_k=args.top_k, top_p=args.top_p,
                                   min_p=args.min_p,
                                   repetition_penalty=args.repetition_penalty,
                                   seed=args.sample_seed + i, greedy=False)
                    for i in range(args.batch)]
    res = eng.generate(batch, sampling=sampling, page_size=args.page_size)
    for i in range(args.batch):
        n = int(res["n_generated"][i])
        print(f"req{i} len={int(batch['lens'][i]):2d} -> "
              f"{res['tokens'][i, :n].tolist()}")


if __name__ == "__main__":
    main()
