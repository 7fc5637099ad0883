"""Carry weights across from the JAX package's parameter trees.

``from_jax_params`` takes the tree that the family's JAX ``init`` returns,
after ``jax.tree.map(np.asarray, params)``: nested dicts of numpy arrays.
dense and ssm stack ``blocks`` over a leading layer axis (dense's vlm
variant stacks ``groups.self`` over (n_groups, n_self) and
``groups.cross`` over (n_groups,)); moe stacks ``dense_blocks`` (when
``first_k_dense``) and ``blocks`` over theirs, each MoE layer's expert
weights whole (E, ...); hybrid stacks ``main`` over (n_groups, period) and
``tail`` over its layers, and keeps ``shared`` unstacked; encdec stacks
``enc_blocks`` and ``dec_blocks`` (two attentions each) over their layers
and keeps ``enc_norm`` unstacked.  ``state_from_jax`` carries a whole
JAX train state across (the masters and AdamW's ``m``/``v`` by the port's
parameter names, ``count`` and ``step``).  It imports no JAX: only numpy
arrays cross over.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device

from . import dense, encdec, hybrid, moe, ssm


def _copy(dst: torch.Tensor, src):
    # through f32: numpy has no bfloat16, and JAX master weights are f32
    src = np.array(src, dtype=np.float32)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {src.shape} does not match {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(src))


def _copy_module(mod, tree: dict, layer=None):
    for name, arr in tree.items():
        dst = getattr(mod, name)
        if isinstance(arr, dict):
            _copy_module(dst, arr, layer)
        else:
            _copy(dst, arr if layer is None else arr[layer])


def from_jax_params(cfg, params_np: dict, device=None):
    """Build the port's model of ``cfg.family`` (``DenseLM``, ``MoELM``,
    ``SSMLM``, ``HybridLM`` or ``EncDecLM``) from a numpy copy of the JAX
    params: matmul and conv
    weights and embeddings cast to ``cfg.compute_dtype``; norms, ``A_log``,
    ``D``, ``dt_bias`` and the MoE router in f32."""
    dev = resolve_device(device)
    if cfg.family == "hybrid":
        model = hybrid.HybridLM(cfg, dev)
        _copy_module(model.shared, params_np["shared"])
        for gi, group in enumerate(model.main):
            for li, blk in enumerate(group):
                _copy_module(blk, params_np["main"], layer=(gi, li))
        for li, blk in enumerate(model.tail):
            _copy_module(blk, params_np["tail"], layer=li)
    elif cfg.family == "moe":
        model = moe.MoELM(cfg, dev)
        for li, blk in enumerate(model.dense_blocks):
            _copy_module(blk, params_np["dense_blocks"], layer=li)
        for li, blk in enumerate(model.blocks):
            _copy_module(blk, params_np["blocks"], layer=li)
    elif cfg.family == "encdec":
        model = encdec.EncDecLM(cfg, dev)
        for li, blk in enumerate(model.enc_blocks):
            _copy_module(blk, params_np["enc_blocks"], layer=li)
        for li, blk in enumerate(model.dec_blocks):
            _copy_module(blk, params_np["dec_blocks"], layer=li)
        _copy_module(model.enc_norm, params_np["enc_norm"])
    elif cfg.family == "dense" and cfg.cross_attn_group:
        model = dense.DenseLM(cfg, dev)
        groups = params_np["groups"]
        for gi, group in enumerate(model.groups["self"]):
            for si, blk in enumerate(group):
                _copy_module(blk, groups["self"], layer=(gi, si))
        for gi, blk in enumerate(model.groups["cross"]):
            _copy_module(blk, groups["cross"], layer=gi)
    else:
        model = (ssm.SSMLM if cfg.family == "ssm" else dense.DenseLM)(cfg, dev)
        for li, blk in enumerate(model.blocks):
            _copy_module(blk, params_np["blocks"], layer=li)
    _copy_module(model.embed, params_np["embed"])
    _copy_module(model.final_norm, params_np["final_norm"])
    return model


def named_from_jax(cfg, tree_np: dict, device=None) -> dict:
    """A numpy copy of a tree in the layout of the family's JAX params
    (the params themselves, their gradients, a moment) as f32 tensors by
    the port's parameter names."""
    model = from_jax_params(cfg.replace(compute_dtype="float32"), tree_np,
                            device)
    return {n: p.detach() for n, p in model.named_parameters()}


def state_from_jax(cfg, state_np: dict, device=None) -> dict:
    """The port's train state (``train.step``'s layout: f32 masters that
    require grad, ``opt`` with f32 ``m``/``v`` and int32 ``count``, int32
    ``step``) from a numpy copy of a JAX train state."""
    dev = resolve_device(device)
    opt = state_np["opt"]
    scalar = lambda x: torch.tensor(int(np.asarray(x)), dtype=torch.int32,
                                    device=dev)
    return {"params": {n: t.requires_grad_(True) for n, t in
                       named_from_jax(cfg, state_np["params"], dev).items()},
            "opt": {"m": named_from_jax(cfg, opt["m"], dev),
                    "v": named_from_jax(cfg, opt["v"], dev),
                    "count": scalar(opt["count"])},
            "step": scalar(state_np["step"])}
