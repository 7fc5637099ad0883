"""Shared set-up of the ``test_torch_*`` parity tests: tiny configs for both
packages, and a JAX model with its converted PyTorch twin.

The JAX side runs with ``attn_impl="kernel"`` and ``ssd_impl="kernel"``, so
its Pallas kernels run in interpret mode as the JAX package's own tests run
them.  The dense config is the ``BASE`` of ``test_paged_cache.py`` with
stablelm's layernorm and 25% partial rotary, in f32; ``FAMILY`` holds the
overrides of the ssm (2 layers) and hybrid (3 layers, the shared block
every 2, so one group and a one-block tail) twins, at the JAX launcher's
reduced SSM sizes, and of the moe twins: the moe config of
``test_paged_cache._family_cfg`` (one dense layer, 4 experts top-2,
capacity factor 4.0 so nothing drops) with olmoe's rmsnorm and qk-norm, and
a ``moe_shared`` variant with one shared expert.
"""

import functools

import jax
import numpy as np

from repro.models import ModelConfig as JaxConfig
from repro.models import get_model as jax_get_model
from repro_torch.models import ModelConfig as TorchConfig
from repro_torch.models.convert import from_jax_params

BASE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=64, param_dtype="float32",
            compute_dtype="float32", norm="layernorm",
            partial_rotary_factor=0.25)
TOL = dict(atol=1e-4, rtol=1e-4)
_SSM = dict(norm="rmsnorm", partial_rotary_factor=1.0, ssm_state=16,
            ssm_headdim=16, ssm_chunk=16)
_MOE = dict(family="moe", norm="rmsnorm", partial_rotary_factor=1.0,
            qk_norm=True, first_k_dense=1, n_experts=4, top_k=2,
            capacity_factor=4.0)
FAMILY = {
    "ssm": dict(_SSM, family="ssm"),
    "hybrid": dict(_SSM, family="hybrid", n_layers=3, shared_attn_period=2),
    "moe": dict(_MOE),
    "moe_shared": dict(_MOE, n_shared_experts=1),
}


def configs(**over):
    """(JAX config with Pallas kernels, port config) for the same model."""
    kw = dict(BASE, **over)
    return (JaxConfig(**kw, attn_impl="kernel", ssd_impl="kernel"),
            TorchConfig(**kw))


@functools.lru_cache(maxsize=None)
def models(seed=0, **over):
    """(jax cfg, jax params, torch cfg, torch model on the CPU), built once
    per (seed, overrides); tests read the weights and never write them."""
    cfg_j, cfg_t = configs(**over)
    params, _ = jax_get_model(cfg_j).init(jax.random.PRNGKey(seed), cfg_j)
    params_np = jax.tree.map(np.asarray, params)
    return cfg_j, params, cfg_t, from_jax_params(cfg_t, params_np, device="cpu")


def family_models(family, seed=0):
    """``models`` for the twin of ``FAMILY[family]``."""
    return models(seed, **FAMILY[family])


def np_(x):
    """numpy copy of a JAX array or torch tensor."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
