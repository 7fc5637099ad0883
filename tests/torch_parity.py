"""Shared set-up of the ``test_torch_*`` parity tests: one tiny dense config
for both packages, and a JAX model with its converted PyTorch twin.

The JAX side runs with ``attn_impl="kernel"``, so its Pallas kernels run in
interpret mode as the JAX package's own tests run them.  The config is the
``BASE`` of ``test_paged_cache.py`` with stablelm's layernorm and 25%
partial rotary, in f32.
"""

import functools

import jax
import numpy as np

from repro.models import ModelConfig as JaxConfig
from repro.models import dense as jax_dense
from repro_torch.models import ModelConfig as TorchConfig
from repro_torch.models.convert import from_jax_params

BASE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=64, param_dtype="float32",
            compute_dtype="float32", norm="layernorm",
            partial_rotary_factor=0.25)
TOL = dict(atol=1e-4, rtol=1e-4)


def configs(**over):
    """(JAX config with Pallas kernels, port config) for the same model."""
    kw = dict(BASE, **over)
    return JaxConfig(**kw, attn_impl="kernel"), TorchConfig(**kw)


@functools.lru_cache(maxsize=None)
def models(seed=0, **over):
    """(jax cfg, jax params, torch cfg, torch DenseLM on the CPU), built once
    per (seed, overrides); tests read the weights and never write them."""
    cfg_j, cfg_t = configs(**over)
    params, _ = jax_dense.init(jax.random.PRNGKey(seed), cfg_j)
    params_np = jax.tree.map(np.asarray, params)
    return cfg_j, params, cfg_t, from_jax_params(cfg_t, params_np, device="cpu")


def np_(x):
    """numpy copy of a JAX array or torch tensor."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
