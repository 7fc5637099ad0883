"""Carry weights across from the JAX package's dense parameter tree.

``from_jax_params`` takes the tree that ``repro.models.dense.init`` returns,
after ``jax.tree.map(np.asarray, params)``: nested dicts of numpy arrays
whose ``blocks`` leaves are stacked over a leading layer axis.  It imports no
JAX: only numpy arrays cross over.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device

from . import dense


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


def from_jax_params(cfg, params_np: dict, device=None) -> dense.DenseLM:
    """Build the port's ``DenseLM`` from a numpy copy of the JAX dense
    params: one ``Block`` per layer, matmul weights and embeddings cast to
    ``cfg.compute_dtype``, norms in f32."""
    dev = resolve_device(device)
    model = dense.DenseLM(cfg, dev)
    _copy_module(model.embed, params_np["embed"])
    _copy_module(model.final_norm, params_np["final_norm"])
    for li, blk in enumerate(model.blocks):
        _copy_module(blk, params_np["blocks"], layer=li)
    return model
