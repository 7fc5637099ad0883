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
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from repro_torch.core.device import resolve_device
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


def init_state(cfg, generator: torch.Generator | None = None, device=None):
    """A fresh state: the family's ``init`` weights drawn in
    ``cfg.param_dtype`` (the serving model's draws before their cast),
    zero moments, step 0.  ``generator`` defaults to one on ``device``
    seeded with 0."""
    dev = resolve_device(device)
    model = get_model(cfg).init(cfg.replace(compute_dtype=cfg.param_dtype),
                                generator, dev)
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


def state_bytes(cfg) -> int:
    """Bytes of a state on the card: f32 masters, f32 gradients and two f32
    moments, 16 bytes a parameter (activations not counted)."""
    return 16 * cfg.param_count()


def make_grads(cfg, *, lb_coef=0.02, z_coef=1e-3, z_loss=0.0,
               microbatch: int = 1) -> Callable:
    """``grads(params, batch) -> ((loss, aux), grads)``: the model's loss
    (cross entropy, + ``lb_coef`` lb_loss + ``z_coef`` router_z for MoE)
    and its gradients with respect to the f32 masters ``params`` (a dict by
    name), as JAX's ``_grads`` in ``make_train_step``.

    ``microbatch`` > 1 splits the batch into that many accumulation chunks
    as JAX does: the batch dim is reshaped (B,) -> (B/m, m) and transposed,
    so chunk i holds rows i, i + m, ...; gradients accumulate in f32 and
    the loss, aux and gradients are averaged.
    """
    fam = get_model(cfg)
    model = skeleton(cfg)
    dtypes = {n: p.dtype for n, p in model.named_parameters()}

    def loss_and_grads(params, batch):
        names = list(params)
        compute = {n: params[n] if n in KEEP_F32 else params[n].to(dtypes[n])
                   for n in names}
        with bound(model, compute):
            logits, aux = fam.train_logits(model, cfg, batch)
            loss = cross_entropy_loss(logits, batch["labels"], z_loss=z_loss)
            if "lb_loss" in aux:
                loss = (loss + lb_coef * aux["lb_loss"]
                        + z_coef * aux["router_z"])
            del logits
            grads = torch.autograd.grad(loss, [params[n] for n in names],
                                        allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        return (loss.detach(), {k: v.detach() for k, v in aux.items()}), grads

    def split(x):
        b = x.shape[0]
        if b % microbatch:
            raise ValueError(f"batch {b} is not a multiple of microbatch "
                             f"{microbatch}")
        return x.reshape((b // microbatch, microbatch) + x.shape[1:]).movedim(1, 0)

    def grads_of(params, batch):
        if microbatch <= 1:
            return loss_and_grads(params, batch)
        mbatch = {k: split(v) for k, v in batch.items()}
        gsum = loss_sum = aux_sum = None
        for i in range(microbatch):
            (loss, aux), g = loss_and_grads(
                params, {k: v[i].contiguous() for k, v in mbatch.items()})
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

    return grads_of


def make_train_step(cfg, *, peak_lr=3e-4, warmup=100, total=10000,
                    grad_clip=1.0, lb_coef=0.02, z_coef=1e-3,
                    z_loss=0.0, microbatch: int = 1) -> Callable:
    """One fused fwd+bwd+AdamW step: ``train_step(state, batch) -> (state,
    metrics)`` with metrics ``loss``, ``grad_norm``, ``lr`` and the model's
    aux (MoE: ``lb_loss``, ``router_z``, ``dropped_frac``), 0-d tensors.
    The gradients are ``make_grads``' (``microbatch`` as there), clipped to
    ``grad_clip``; the learning rate is ``cosine_warmup`` at the state's
    step.  The state is updated in place (see the module's docstring)."""
    grads_of = make_grads(cfg, lb_coef=lb_coef, z_coef=z_coef, z_loss=z_loss,
                          microbatch=microbatch)

    def train_step(state, batch):
        (loss, aux), grads = grads_of(state["params"], batch)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
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
