"""Training launcher of the port, mirroring ``repro.launch.train``: real
training of one arch on one device, or on a ``data x model`` mesh of
ranks, through the fault-tolerant loop.

    python -m repro_torch.launch.train --arch mamba2_130m --steps 50 \
        --batch 8 --seq 128 --reduce --device cpu
    python -m repro_torch.launch.train --arch mamba2_130m --seq 2048 --batch 8
    python -m repro_torch.launch.train --arch stablelm_3b --reduce \
        --device cpu --mesh 2x2

It prints the JAX launcher's lines (``arch=... params=...``, ``step ...
loss ...`` every 5 steps, ``loss a -> b``; on a mesh, rank 0 prints them).
Data is ``SyntheticLM`` (seed 0); the weights are random from seed 0 on
the device.  ``--reduce`` shrinks the dims as the JAX launcher does
(keeping family and topology); without it the published widths run, on the
card by default.

``--mesh DxM`` starts D x M ranks (``launch.mesh.run_ranks``; under
``torchrun`` it joins that group) that train one sharded state
(``train.step``: FSDP over "data", heads, MLP columns, experts and vocab
over "model"); an MoE arch dispatches in D token groups (``moe_groups``, as
the JAX dry run sets it).  A mesh it does not cover (a head cut in two,
``tp_sp``) exits naming ROADMAP Queue 1 item 14 before any rank starts.
A state whose f32 weights, gradients and moments (16 bytes a parameter)
per rank, times the ranks that share one card, do not fit the card's
memory raises naming the bytes.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import types

import numpy as np
import torch

from repro_torch.configs import all_arch_names, get_config
from repro_torch.core.device import resolve_device
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import join_group, parse_mesh, run_ranks
from repro_torch.runtime import FaultTolerantLoop
from repro_torch.train.step import (check_train_mesh, init_state,
                                    local_params, make_train_step,
                                    state_shardings)

MESH_AXES = ("data", "model")

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


def card_bytes(cfg, shape=None, per_card: int = 1) -> int:
    """Bytes of training state on one card: f32 masters, gradients and two
    moments (16 bytes a parameter) of one rank's block of every parameter
    on a mesh of ``shape`` (axis -> size; None: one device), times the
    ``per_card`` ranks that share the card (activations not counted)."""
    if shape is None:
        return 16 * cfg.param_count()
    mesh = types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))
    return 16 * local_params(cfg, mesh) * per_card


def check_fits(cfg, device, shape=None) -> None:
    """Raise if the state of ``cfg`` (one rank's block on a mesh of
    ``shape``, times the ranks that share a card) does not fit the card's
    memory."""
    if device.type != "cuda":
        return
    world = 1 if shape is None else int(np.prod(list(shape.values())))
    per_card = world if torch.cuda.device_count() < world else 1
    need = card_bytes(cfg, shape, per_card)
    have = torch.cuda.get_device_properties(device).total_memory
    if need > have:
        where = ("" if shape is None else
                 f" a rank's block on mesh {shape}, x {per_card} rank(s) "
                 "sharing the card,")
        raise RuntimeError(
            f"{cfg.name}: {cfg.param_count() / 1e9:.2f} B params;{where} "
            f"16 B a parameter of f32 weights, gradients and moments = "
            f"{need / 1e9:.1f} GB, more than the card's {have / 1e9:.0f} GB")


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
                    help="train over D x M ranks (data x model)")
    return ap


def main(argv=None, *, fault_injector=None):
    """Parse ``argv``, train, print; returns (state, history, loop), or on
    a mesh rank 0's (None, history, None).  ``fault_injector(step)`` is
    handed to ``FaultTolerantLoop.run`` (on a mesh, every rank's)."""
    ap = parser()
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg)
    if args.mesh is None:
        device = resolve_device(args.device)
        print(f"arch={cfg.name} family={cfg.family} "
              f"params={cfg.param_count():.3e}")
        check_fits(cfg, device)
        return train(None, args, cfg, fault_injector)
    # every refusal before any rank starts
    try:
        d, m = parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    shape = dict(zip(MESH_AXES, (d, m)))
    if cfg.family == "moe" and cfg.moe_groups == 1:
        cfg = cfg.replace(moe_groups=d)
    try:
        check_train_mesh(cfg, shape)
    except NotImplementedError as e:
        sys.exit(f"--mesh {args.mesh}: {e}")
    device = resolve_device(args.device)
    print(f"arch={cfg.name} family={cfg.family} params={cfg.param_count():.3e}")
    check_fits(cfg, device, shape)
    if "WORLD_SIZE" in os.environ:
        # under torchrun: join the group it describes
        import torch.distributed as dist
        mesh = join_group((d, m), MESH_AXES, device=args.device)
        try:
            return train(mesh, args, cfg, fault_injector)
        finally:
            dist.destroy_process_group()
    hist = run_ranks(_rank, (d, m), MESH_AXES, args, cfg, fault_injector,
                     device=args.device, timeout=None)[0]
    return None, hist, None


def _rank(mesh, args, cfg, fault_injector):
    """One rank of ``--mesh``: its history of (step, loss)."""
    return train(mesh, args, cfg, fault_injector)[1]


def train(mesh, args, cfg, fault_injector=None):
    """Train ``cfg`` as ``args`` say, on one device (``mesh`` None) or as
    this rank of ``mesh``; prints the JAX launcher's lines (rank 0 of a
    mesh).  Returns (state, history, loop)."""
    device = resolve_device(args.device) if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_state(cfg, gen, device, mesh=mesh)
    step = make_train_step(cfg, microbatch=args.microbatch, mesh=mesh)
    data = SyntheticLM(cfg.vocab_size, args.seq, seed=0)
    loop = FaultTolerantLoop(
        step, make_batch_fn(cfg, data, args.batch, args.seq, device),
        ckpt_dir=args.ckpt_dir, save_every=10, mesh=mesh,
        state_shardings=None if mesh is None else state_shardings(cfg, mesh))
    state, hist = loop.run(
        state, args.steps, fault_injector=fault_injector,
        metrics_cb=lambda s, m: print(
            f"  step {s:3d} loss {float(m['loss']):.4f}", flush=True)
        if lead and s % 5 == 0 else None)
    if hist and lead:
        print(f"loss {hist[0][1]:.4f} -> {hist[-1][1]:.4f}", flush=True)
    return state, hist, loop


if __name__ == "__main__":
    main()
