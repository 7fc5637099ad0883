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

The scheduler's parity tests run the JAX side on its plain XLA path
(``plain_models``: the model config's default ``attn_impl``/``ssd_impl``,
as the JAX package's own scheduler tests run it) and serve one ragged trace
(``sched_trace``) through both schedulers (``serve_trace``).
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


@functools.lru_cache(maxsize=None)
def plain_models(seed=0, **over):
    """``models`` with the JAX side on its plain XLA path (the config's
    default ``attn_impl``/``ssd_impl``), for the scheduler's long traces."""
    kw = dict(BASE, **over)
    cfg_j, cfg_t = JaxConfig(**kw), TorchConfig(**kw)
    params, _ = jax_get_model(cfg_j).init(jax.random.PRNGKey(seed), cfg_j)
    params_np = jax.tree.map(np.asarray, params)
    return cfg_j, params, cfg_t, from_jax_params(cfg_t, params_np, device="cpu")


def jax_scheduler_seeding_swapped_pages():
    """The JAX scheduler with ``_start_partial`` seeding the first chunk from
    every prefix page, paged-in ones included.  The JAX package seeds a
    chunked request's sub-cache from RESIDENT shared pages only
    (``plan.shared``), so a request whose prefix pages all came back from
    the host-swap tier prefills its chunks over a zero prefix (ROADMAP
    Queue 3 item 10); the port seeds both, and its parity tests hold it
    against this subclass.  The JAX package is not edited."""
    from repro.serve import ContinuousBatchingScheduler
    from repro.serve.scheduler import _Partial

    class Seeding(ContinuousBatchingScheduler):
        def _start_partial(self, req, plan, lane):
            lane = int(lane)
            budget = (plan.budget if plan is not None
                      else self._budget_for(req, len(req.tokens)))
            sub_cache = self.engine.make_cache(1, self.max_len,
                                               src_len=self.src_len)
            seed = (self._seed_arrays([plan], 1) if plan is not None
                    else None)
            self.lane_rid[lane] = req.rid
            self._lane_pending[lane] = True
            self._partials.append(_Partial(
                req=req, plan=plan, lane=lane, sub_cache=sub_cache, done=0,
                pos0=plan.pos0 if plan is not None else 0, budget=budget,
                seed=seed))
            self.obs.request_event(req.rid, "prefill_start", lane=lane,
                                   suffix=len(req.tokens)
                                   - (plan.pos0 if plan is not None else 0))

    return Seeding


def sched_trace(rng, n, *, shared_prefix=None, vocab=64):
    """A ragged trace of ``(arrival, prompt, max_new_tokens)``: staggered
    arrivals, ragged prompts (3-13 tokens, or a shared prefix + suffix cut
    to 16 on about half of them when ``shared_prefix`` is given) and
    ragged budgets (3-7)."""
    out, t = [], 0.0
    for _ in range(n):
        t += rng.exponential(1.5)
        prompt = rng.randint(1, vocab, rng.randint(3, 14))
        if shared_prefix is not None and rng.rand() < 0.5:
            prompt = np.concatenate([shared_prefix, prompt])[:16]
        out.append((t, prompt, int(rng.randint(3, 8))))
    return out


def serve_trace(sched_cls, sampling_cls, engine, trace, *, capacity=4,
                max_len=24, chunk=4, compact_threshold=0.5, **kw):
    """Serve ``trace`` through one package's scheduler, every third request
    sampling at T=0.8 (its own seed), the rest greedy: (results, a copy of
    the stats, the scheduler)."""
    sched = sched_cls(engine, capacity=capacity, max_len=max_len, chunk=chunk,
                      compact_threshold=compact_threshold, **kw)
    for rid, (arrival, prompt, max_new) in enumerate(trace):
        sp = (sampling_cls(temperature=0.8, top_p=0.9, seed=rid, greedy=False)
              if rid % 3 == 0 else None)
        sched.submit(prompt, arrival=arrival, max_new_tokens=max_new,
                     sampling=sp)
    results = sched.run()
    stats = {k: (list(v) if isinstance(v, list) else v)
             for k, v in sched.stats.items()}
    return results, stats, sched


def assert_same_results(got, want, tag=""):
    """Byte-for-byte tokens, equal ``n_generated`` and finish reasons."""
    assert sorted(got) == sorted(want), tag
    for rid in want:
        g, w = got[rid], want[rid]
        assert g["n_generated"] == w["n_generated"], (tag, rid)
        assert g["tokens"].dtype == w["tokens"].dtype, (tag, rid)
        assert g["tokens"].tobytes() == w["tokens"].tobytes(), \
            (tag, rid, g["tokens"], w["tokens"])
        assert g["finish_reason"].value == w["finish_reason"].value, (tag, rid)
