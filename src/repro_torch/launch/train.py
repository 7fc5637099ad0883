"""Training launcher of the port, mirroring ``repro.launch.train``: real
training of one arch on one device through the fault-tolerant loop.

    python -m repro_torch.launch.train --arch mamba2_130m --steps 50 \
        --batch 8 --seq 128 --reduce --device cpu
    python -m repro_torch.launch.train --arch mamba2_130m --seq 2048 --batch 8

It prints the JAX launcher's lines (``arch=... params=...``, ``step ...
loss ...`` every 5 steps, ``loss a -> b``).  Data is ``SyntheticLM`` (seed
0); the weights are random from seed 0 on the device.  ``--reduce`` shrinks
the dims as the JAX launcher does (keeping family and topology); without it
the published widths run, on the card by default.  An arch whose f32
weights, gradients and moments (16 bytes a parameter) do not fit the
card's memory raises naming the bytes: sharding them waits for the port's
mesh (ROADMAP Queue 1 item 14), and ``--mesh`` exits naming that item
(the port serves on a mesh but does not train on one yet).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import all_arch_names, get_config
from repro_torch.core.device import resolve_device
from repro_torch.data import SyntheticLM
from repro_torch.runtime import FaultTolerantLoop
from repro_torch.train.step import init_state, make_train_step, state_bytes

REDUCE = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=256, n_heads=4,
              n_kv_heads=2, head_dim=16, n_cross_tokens=16,
              param_dtype="float32", compute_dtype="float32")


def reduced(cfg):
    """The JAX launchers' ``--reduce`` overrides of ``cfg``, for training
    and serving alike (the serving launcher's MoE ``d_ff_dense`` = 128 is
    read only by ``first_k_dense`` blocks, so it is set only for them)."""
    over = dict(REDUCE)
    if cfg.family in ("ssm", "hybrid"):
        over.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
    if cfg.family == "moe":
        over.update(n_experts=8, top_k=2,
                    d_ff_dense=128 if cfg.first_k_dense else None)
    if cfg.family == "encdec":
        over.update(n_enc_layers=2, n_dec_layers=2)
    if cfg.family == "hybrid":
        over.update(n_layers=5, shared_attn_period=2)
    if cfg.cross_attn_group:
        over.update(n_layers=10)
    return cfg.replace(**{k: v for k, v in over.items() if v is not None})


def check_fits(cfg, device) -> None:
    """Raise if the state of ``cfg`` does not fit the card's memory."""
    if device.type != "cuda":
        return
    need = state_bytes(cfg)
    have = torch.cuda.get_device_properties(device).total_memory
    if need > have:
        raise RuntimeError(
            f"{cfg.name}: {cfg.param_count() / 1e9:.2f} B params x 16 B = "
            f"{need / 1e9:.0f} GB of f32 weights, gradients and moments, more "
            f"than the card's {have / 1e9:.0f} GB; sharding the state waits "
            "for the port's mesh (ROADMAP Queue 1 item 14)")


def make_batch_fn(cfg, data: SyntheticLM, batch: int, seq: int, device):
    """step -> the batch of ``data`` at that step on ``device`` (plus the
    VLM's image embeddings or the encdec encoder inputs, seeded by step)."""
    def batch_fn(s):
        tokens, labels, lens = data.batch(s, batch)
        out = {"tokens": torch.from_numpy(tokens).to(device),
               "labels": torch.from_numpy(labels).to(device),
               "lens": torch.from_numpy(lens).to(device)}
        if cfg.family == "dense" and cfg.cross_attn_group:
            out["cross_emb"] = torch.from_numpy(
                np.random.RandomState(s).randn(
                    batch, cfg.n_cross_tokens, cfg.d_model)
                .astype(np.float32)).to(device)
        if cfg.family == "encdec":
            out["src_emb"] = torch.from_numpy(
                np.random.RandomState(s).randn(batch, seq, cfg.d_model)
                .astype(np.float32)).to(device)
            out["src_lens"] = torch.full((batch,), seq, dtype=torch.int32,
                                         device=device)
        return out
    return batch_fn


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_130m", choices=all_arch_names())
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduce", action="store_true",
                    help="shrink dims (keeps family/topology)")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="training on a mesh: not ported yet (exits naming "
                         "its ROADMAP item)")
    return ap


def main(argv=None, *, fault_injector=None):
    """Parse ``argv``, train, print; returns (state, history, loop).
    ``fault_injector(step)`` is handed to ``FaultTolerantLoop.run``."""
    args = parser().parse_args(argv)
    if args.mesh is not None:
        raise SystemExit(
            f"--mesh {args.mesh}: training on a mesh (row-parallel products, "
            "their psum and a sharded optimizer state) is not ported yet "
            "(ROADMAP Queue 1 item 14)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg)
    print(f"arch={cfg.name} family={cfg.family} params={cfg.param_count():.3e}")
    check_fits(cfg, device)

    gen = torch.Generator(device=device).manual_seed(0)
    state = init_state(cfg, gen, device)
    step = make_train_step(cfg, microbatch=args.microbatch)
    data = SyntheticLM(cfg.vocab_size, args.seq, seed=0)
    loop = FaultTolerantLoop(step, make_batch_fn(cfg, data, args.batch,
                                                 args.seq, device),
                             ckpt_dir=args.ckpt_dir, save_every=10)
    state, hist = loop.run(
        state, args.steps, fault_injector=fault_injector,
        metrics_cb=lambda s, m: print(
            f"  step {s:3d} loss {float(m['loss']):.4f}") if s % 5 == 0 else None)
    if hist:
        print(f"loss {hist[0][1]:.4f} -> {hist[-1][1]:.4f}")
    return state, hist, loop


if __name__ == "__main__":
    main()
