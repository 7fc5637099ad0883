"""The train step factory, mirroring ``repro.train.step``: one fused
forward, backward and AdamW update.

The state is a dict of tensors, as JAX's: ``params`` (f32 master weights,
``cfg.param_dtype``, by ``named_parameters`` name), ``opt`` (``m``/``v`` in
f32 and ``count``) and ``step``.  A step runs the family's
``train_logits`` on a skeleton of the model (its module tree on the meta
device) whose parameters are, for that step, the masters cast to the dtypes
the serving model holds them in (the compute dtype for matmul weights, f32
for norms and the SSM and router constants; the embedding table stays f32
and its gather casts the rows, as JAX's ``embed``).  Gradients reach the
masters through the casts, in f32.

The step consumes its state: the masters, moments and count are updated in
place and returned, as the JAX launcher donates its state (a second copy of
a 3B model's state would not fit one card).  Copy a state
(``copy_state``) before a step to keep it.

On a ``data x model`` mesh (``mesh=``, a ``launch.mesh.Mesh``) the state
is sharded as JAX's ``abstract_state`` axes place it under
``DEFAULT_RULES`` (``state_axes``, ``state_shardings``): each rank holds
its block of every master and of ``m``/``v`` (FSDP over "data"; heads,
MLP columns, experts and vocab over "model"; ``count`` and ``step``
whole).  A step takes the whole batch and trains on this rank's block of
its lanes (the divisibility fallback: all of them where "data" does not
divide the batch); each weight is gathered whole over "data" for the
forward and its gradient reduce-scattered back (``sharding.fsdp_gather``,
``fsdp_reduce``: one flat collective per dtype);
the layers run the model axis's Megatron pairs (``models.layers``); the
loss, the aux losses and the global norm are the whole batch's and the
whole model's, the same bits on every rank.  A model axis that cuts a head
in two, ``act_shard="tp_sp"`` and a "pod" axis are refused
(``check_train_mesh``).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from repro_torch.core.device import resolve_device
from repro_torch.dist import sharding as SH
from repro_torch.dist.serve import param_axes
from repro_torch.models import get_model
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_warmup)

from .loss import cross_entropy_loss

#: parameters that stay f32 in a step: the embedding table, whose gather
#: casts its rows (and whose tied unembedding casts it whole)
KEEP_F32 = ("embed.tok",)


def skeleton(cfg):
    """The family's model with the module tree of ``cfg`` on the meta
    device: no storage, the serving dtypes."""
    fam = get_model(cfg)
    cls = {"dense": "DenseLM", "moe": "MoELM", "ssm": "SSMLM",
           "hybrid": "HybridLM", "encdec": "EncDecLM"}[cfg.family]
    return getattr(fam, cls)(cfg, torch.device("meta"))


@contextlib.contextmanager
def bound(model, tensors: dict):
    """Within the block ``model``'s parameters are ``tensors`` (by
    ``named_parameters`` name); after it, what they were."""
    slots = []
    try:
        for name, t in tensors.items():
            mod_name, _, attr = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            slots.append((mod, attr, mod._parameters[attr]))
            mod._parameters[attr] = t
        yield model
    finally:
        for mod, attr, old in reversed(slots):
            mod._parameters[attr] = old


_ITEM = "ROADMAP Queue 1 item 14"


def check_train_mesh(cfg, shape: dict) -> None:
    """Refuse, naming the ROADMAP item that ports it, a mesh (``shape``:
    axis name -> size) that training ``cfg`` on a mesh does not cover: a
    model axis that does not cut the heads and the KV heads into
    whole-head blocks (an ssm model cuts no heads), the sequence-parallel
    residual (``act_shard="tp_sp"``) and a "pod" axis."""
    unknown = set(shape) - {"pod", "data", "model"}
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}")
    if shape.get("pod", 1) > 1:
        raise NotImplementedError(f"training over a pod axis is not ported "
                                  f"yet ({_ITEM})")
    if cfg.act_shard == "tp_sp":
        raise NotImplementedError(
            "act_shard='tp_sp' (the sequence-parallel residual, Megatron-SP) "
            f"is not ported yet ({_ITEM})")
    if cfg.act_shard not in ("none", "tp"):
        raise ValueError(f"act_shard must be none, tp or tp_sp, got "
                         f"{cfg.act_shard!r}")
    m = shape.get("model", 1)
    if cfg.family != "ssm" and (cfg.n_heads % m or cfg.n_kv_heads % m):
        raise NotImplementedError(
            f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads do not cut "
            f"into {m} whole-head blocks: training with a head cut in two is "
            f"not ported yet ({_ITEM})")


def state_axes(cfg) -> dict:
    """The logical axes of every leaf of a state, as JAX's
    ``abstract_state`` gives them: the parameters' by name, ``m`` and
    ``v`` mirroring them, ``count`` and ``step`` replicated."""
    p_axes = param_axes(skeleton(cfg), cfg)
    return {"params": p_axes, "opt": {"m": p_axes, "v": p_axes, "count": ()},
            "step": ()}


def state_shardings(cfg, mesh) -> dict:
    """The spec of every leaf of a state on ``mesh`` under
    ``DEFAULT_RULES``, in the state's structure (``state_axes`` resolved
    against the whole parameters' shapes)."""
    axes = state_axes(cfg)["params"]
    p_sh = {n: SH.spec_for(p.shape, axes[n], mesh)
            for n, p in skeleton(cfg).named_parameters()}
    return {"params": p_sh, "opt": {"m": p_sh, "v": p_sh, "count": ()},
            "step": ()}


def shard_state(state, shardings, mesh):
    """This rank's block of every leaf of a whole ``state`` (copies, so the
    whole tensors can be freed)."""
    return SH.tree_map(
        lambda t, spec: SH.local_slice(t.detach(), spec, mesh).clone()
        .requires_grad_(t.requires_grad), state, shardings)


def gather_state(state, shardings, mesh):
    """Every leaf of a sharded ``state`` gathered whole (a collective:
    every rank calls it, and every rank gets the whole state)."""
    return SH.tree_map(lambda t, spec: SH.gather_whole(t.detach(), spec, mesh),
                       state, shardings)


def local_params(cfg, mesh) -> int:
    """How many parameters one rank of ``mesh`` holds (``mesh``: anything
    with ``axis_names`` and ``shape``)."""
    specs = state_shardings(cfg, mesh)["params"]
    n = 0
    for name, p in skeleton(cfg).named_parameters():
        blocks = 1
        for entry in specs[name]:
            for a in (() if entry is None else
                      (entry,) if isinstance(entry, str) else entry):
                blocks *= mesh.shape[a]
        n += p.numel() // blocks
    return n


def init_state(cfg, generator: torch.Generator | None = None, device=None,
               mesh=None):
    """A fresh state: the family's ``init`` weights drawn in
    ``cfg.param_dtype`` (the serving model's draws before their cast),
    zero moments, step 0.  ``generator`` defaults to one on ``device``
    seeded with 0.  On a ``mesh`` (see the module's docstring), this
    rank's blocks of that state."""
    dev = resolve_device(device)
    model = get_model(cfg).init(cfg.replace(compute_dtype=cfg.param_dtype),
                                generator, dev)
    if mesh is not None:
        # cut before the moments exist: a rank never holds a whole state
        check_train_mesh(cfg, mesh.shape)
        specs = state_shardings(cfg, mesh)["params"]
        for name, p in model.named_parameters():
            p.data = SH.local_slice(p.data, specs[name], mesh).clone()
    return state_from(model, copy=False)


def state_from(model, *, copy: bool = True):
    """A fresh state (zero moments, step 0) whose masters are ``model``'s
    weights in f32 (e.g. a model ``convert.from_jax_params`` built): copies,
    or with ``copy=False`` the f32 weights themselves."""
    params = {n: (p.detach().float().clone() if copy else p.detach().float())
              .requires_grad_(True) for n, p in model.named_parameters()}
    dev = next(iter(params.values())).device
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def copy_state(state):
    """A deep copy of a state (every tensor cloned)."""
    def cp(x):
        if isinstance(x, dict):
            return {k: cp(v) for k, v in x.items()}
        return x.detach().clone().requires_grad_(x.requires_grad)
    return cp(state)


def lanes_of(batch, mesh):
    """(this rank's block of the lanes of every leaf of ``batch``, whether
    the lanes are cut): "batch" over the data axis where it divides the
    batch (``sharding.batch_axes_for``), else every lane on every rank."""
    specs = SH.tree_shardings(batch, SH.batch_axes_for(batch), mesh)
    cut = any(spec[0] is not None for spec in specs.values())
    return {k: SH.local_slice(v, specs[k], mesh) for k, v in batch.items()}, cut


def make_grads(cfg, *, lb_coef=0.02, z_coef=1e-3, z_loss=0.0,
               microbatch: int = 1, mesh=None) -> Callable:
    """``grads(params, batch) -> ((loss, aux), grads)``: the model's loss
    (cross entropy, + ``lb_coef`` lb_loss + ``z_coef`` router_z for MoE)
    and its gradients with respect to the f32 masters ``params`` (a dict by
    name), as JAX's ``_grads`` in ``make_train_step``.

    ``microbatch`` > 1 splits the batch into that many accumulation chunks
    as JAX does: the batch dim is reshaped (B,) -> (B/m, m) and transposed,
    so chunk i holds rows i, i + m, ...; gradients accumulate in f32 and
    the loss, aux and gradients are averaged.

    On a ``mesh``, ``params`` are this rank's blocks, ``batch`` is the whole
    batch, of which the rank takes its lanes (``lanes_of``; the microbatch
    split is then shard-local, as JAX's), and the gradients are this
    rank's blocks of the whole batch's gradients; loss and aux are the
    whole batch's on every rank.
    """
    fam = get_model(cfg)
    model = skeleton(cfg)
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    if mesh is not None:
        check_train_mesh(cfg, mesh.shape)
        specs = state_shardings(cfg, mesh)["params"]

    def loss_and_grads(params, batch, cut):
        names = list(params)
        cast = lambda: {n: params[n] if n in KEEP_F32
                        else params[n].to(dtypes[n]) for n in names}
        if mesh is None:
            compute = cast()
        else:
            # cast, then gather: the FSDP traffic is in the compute dtype;
            # the gathered weights are the leaves the gradients are of
            with torch.no_grad():
                local = cast()
            compute = {n: t.detach().requires_grad_(True) for n, t in
                       SH.fsdp_gather(local, specs, mesh).items()}
            del local
        wrt = params if mesh is None else compute
        with bound(model, compute):
            logits, aux = fam.train_logits(model, cfg, batch)
            loss = cross_entropy_loss(logits, batch["labels"], z_loss=z_loss)
            if "lb_loss" in aux:
                loss = (loss + lb_coef * aux["lb_loss"]
                        + z_coef * aux["router_z"])
            del logits
            grads = torch.autograd.grad(loss, [wrt[n] for n in names],
                                        allow_unused=True)
        grads = {n: torch.zeros_like(wrt[n]) if g is None else g
                 for n, g in zip(names, grads)}
        del compute, wrt
        if mesh is not None:
            grads = {n: g.float() for n, g in SH.fsdp_reduce(
                grads, specs, mesh, summed=cut).items()}
        return (loss.detach(), {k: v.detach() for k, v in aux.items()}), grads

    def split(x):
        b = x.shape[0]
        if b % microbatch:
            raise ValueError(f"batch {b} is not a multiple of microbatch "
                             f"{microbatch}")
        return x.reshape((b // microbatch, microbatch) + x.shape[1:]).movedim(1, 0)

    def grads_on_lanes(params, batch, cut):
        if microbatch <= 1:
            return loss_and_grads(params, batch, cut)
        mbatch = {k: split(v) for k, v in batch.items()}
        gsum = loss_sum = aux_sum = None
        for i in range(microbatch):
            (loss, aux), g = loss_and_grads(
                params, {k: v[i].contiguous() for k, v in mbatch.items()}, cut)
            if gsum is None:
                gsum = {n: t.float() for n, t in g.items()}
                loss_sum, aux_sum = loss, dict(aux)
            else:
                for n, t in g.items():
                    gsum[n] += t.float()
                loss_sum = loss_sum + loss
                aux_sum = {k: aux_sum[k] + v for k, v in aux.items()}
            del g
        inv = 1.0 / microbatch
        return ((loss_sum * inv, {k: v * inv for k, v in aux_sum.items()}),
                {n: t.mul_(inv) for n, t in gsum.items()})

    def grads_of(params, batch):
        if mesh is None:
            return grads_on_lanes(params, batch, False)
        batch, cut = lanes_of(batch, mesh)
        with SH.use_mesh_rules(mesh), (SH.batch_cut() if cut
                                       else contextlib.nullcontext()):
            return grads_on_lanes(params, batch, cut)

    return grads_of


def make_train_step(cfg, *, peak_lr=3e-4, warmup=100, total=10000,
                    grad_clip=1.0, lb_coef=0.02, z_coef=1e-3,
                    z_loss=0.0, microbatch: int = 1, mesh=None) -> Callable:
    """One fused fwd+bwd+AdamW step: ``train_step(state, batch) -> (state,
    metrics)`` with metrics ``loss``, ``grad_norm``, ``lr`` and the model's
    aux (MoE: ``lb_loss``, ``router_z``, ``dropped_frac``), 0-d tensors.
    The gradients are ``make_grads``' (``microbatch`` and ``mesh`` as
    there), clipped to ``grad_clip``; the learning rate is
    ``cosine_warmup`` at the state's step.  The state is updated in place
    (see the module's docstring); on a ``mesh`` it is this rank's blocks
    (``init_state(mesh=)``, ``shard_state``) and the metrics are the same
    on every rank."""
    grads_of = make_grads(cfg, lb_coef=lb_coef, z_coef=z_coef, z_loss=z_loss,
                          microbatch=microbatch, mesh=mesh)
    specs = None if mesh is None else state_shardings(cfg, mesh)["params"]

    def train_step(state, batch):
        (loss, aux), grads = grads_of(state["params"], batch)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, grad_clip,
                                               shardings=specs, mesh=mesh)
            lr = cosine_warmup(state["step"], peak_lr=peak_lr, warmup=warmup,
                               total=total)
            params, opt = adamw_update(grads, state["opt"], state["params"],
                                       lr=lr)
        del grads
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, **aux}
        return {"params": params, "opt": opt, "step": state["step"] + 1}, metrics

    return train_step


def make_serve_fns(cfg):
    """(prefill_step, decode_step) over a serving model: the family's
    ``prefill`` and ``decode``."""
    fam = get_model(cfg)

    def prefill_step(model, batch, cache):
        return fam.prefill(model, cfg, batch, cache)

    def decode_step(model, batch, cache):
        return fam.decode(model, cfg, batch, cache)

    return prefill_step, decode_step
