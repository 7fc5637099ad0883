"""Port parity of three dense configs at reduced dims: gemma3-27b (5:1
local:global sliding windows, the local window smaller than the prompts,
qk-norm, geglu, the sqrt(d) embedding scale), command-r-plus-104b (the
parallel attention + MLP block, layernorm, tied embeddings) and
stablelm-12b (its head dim of 160, d 640 over 4 query heads and 1 KV head,
25% partial rotary).  Each config module of ``repro_torch.configs`` against
``repro.configs``, then prefill and decode logits on the dense and the
paged cache (and, for stablelm-12b, the int8 paged cache) against
``repro.models.dense`` with its Pallas kernels in interpret mode (f32, atol
= rtol = 1e-4), and greedy ``generate`` tokens against the JAX engine on
its plain XLA path; inside the port, paged decode == dense bit for bit."""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from torch_parity import TOL, np_

from repro import configs as JCFG
from repro.models import dense as jdense
from repro.models import to_paged as j_to_paged
from repro.serve import ServeEngine as JaxEngine
from repro_torch import configs as TCFG
from repro_torch.models import dense as tdense
from repro_torch.models import to_paged
from repro_torch.models.convert import from_jax_params
from repro_torch.serve import ServeEngine

# the JAX launcher's reduced dims; gemma3 keeps one 5:1 period (layer 5
# global) with a window of 4, under every prompt's length
REDUCE = dict(d_model=64, d_ff=128, vocab_size=256, n_heads=4, n_kv_heads=2,
              head_dim=16, param_dtype="float32", compute_dtype="float32")
# stablelm-12b keeps its head dim of 160 (no head_dim: d 640 / 4 heads)
ARCHS = {"gemma3_27b": dict(n_layers=6, local_window=4),
         "command_r_plus_104b": dict(n_layers=2),
         "stablelm_12b": dict(n_layers=2, d_model=640, n_heads=4, n_kv_heads=1,
                              head_dim=None, vocab_size=512)}
LENS = np.array([9, 5, 7], np.int32)
MAX_NEW, MAX_LEN = 6, 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_config_module_matches_jax(arch):
    j, t = JCFG.get_config(arch), TCFG.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert arch in TCFG.all_arch_names()


@functools.lru_cache(maxsize=None)
def _twins(arch, impl):
    over = dict(REDUCE, **ARCHS[arch])
    cfg_j = JCFG.get_config(arch).replace(**over)
    if impl:
        cfg_j = cfg_j.replace(attn_impl=impl)
    cfg_t = TCFG.get_config(arch).replace(**over)
    params, _ = jdense.init(jax.random.PRNGKey(0), cfg_j)
    model = from_jax_params(cfg_t, jax.tree.map(np.asarray, params),
                            device="cpu")
    return cfg_j, params, cfg_t, model


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(1, cfg.vocab_size, (3, int(LENS.max()))),
            "lens": LENS}


def _close(got, want):
    np.testing.assert_allclose(np_(got), np_(want), **TOL)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_match_jax(arch, paged):
    """Prefill, then 6 teacher-forced decode steps (gemma3's local layers
    slide past the window in both)."""
    cfg_j, params, cfg_t, model = _twins(arch, "kernel")
    if arch == "gemma3_27b":
        assert cfg_t.qk_norm and cfg_t.embed_scale and cfg_t.activation == "geglu"
        assert int(LENS.min()) > cfg_t.local_window
    elif arch == "command_r_plus_104b":
        assert cfg_t.parallel_block and cfg_t.tie_embeddings
        assert model.embed.unembed is None
    else:
        assert cfg_t.resolved_head_dim == 160 and cfg_t.partial_rotary_factor == 0.25
    batch = _batch(cfg_j)
    cj = jdense.make_cache(cfg_j, 3, MAX_LEN)
    lj, cj = jdense.prefill(params, cfg_j,
                            {k: jnp.asarray(v) for k, v in batch.items()}, cj)
    ct = tdense.make_cache(cfg_t, 3, MAX_LEN, device="cpu")
    lt, ct = tdense.prefill(model, cfg_t,
                            {k: torch.from_numpy(v) for k, v in batch.items()},
                            ct)
    _close(lt, lj)
    if paged:
        cj = j_to_paged(cfg_j, cj, page_size=4)
        ct = to_paged(cfg_t, ct, page_size=4)
    tok = np_(lj).argmax(-1)[:, None].astype(np.int32)
    for _ in range(6):
        lj, cj = jdense.decode(params, cfg_j, {"token": jnp.asarray(tok)}, cj)
        lt, ct = tdense.decode(model, cfg_t, {"token": torch.from_numpy(tok)}, ct)
        _close(lt, lj)
        tok = np_(lj).argmax(-1)[:, None].astype(np.int32)


@pytest.mark.parametrize("page_size", [None, 4])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_generate_matches_jax(arch, page_size):
    cfg_j, params, cfg_t, model = _twins(arch, None)
    batch = _batch(cfg_j, seed=1)
    kw = dict(max_new_tokens=MAX_NEW, stop_token=-1)
    rj = JaxEngine(cfg_j, params, **kw).generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, page_size=page_size)
    eng = ServeEngine(cfg_t, model, device="cpu", **kw)
    rt = eng.generate(batch, page_size=page_size)
    assert np_(rt["tokens"]).tobytes() == np_(rj["tokens"]).tobytes()
    if page_size is not None:
        # inside the port the paged cache decodes the dense cache's bits
        assert torch.equal(rt["tokens"], eng.generate(batch)["tokens"])


def test_stablelm_12b_int8_pages_match_jax():
    """stablelm-12b's head dim of 160 over int8 pages: the prefilled cache
    truncated by both packages' ``to_paged``, then 6 teacher-forced decode
    steps, logits against JAX's within 1e-4."""
    cfg_j, params, cfg_t, model = _twins("stablelm_12b", "kernel")
    batch = _batch(cfg_j, seed=2)
    cj = jdense.make_cache(cfg_j, 3, MAX_LEN)
    lj, cj = jdense.prefill(params, cfg_j,
                            {k: jnp.asarray(v) for k, v in batch.items()}, cj)
    ct = tdense.make_cache(cfg_t, 3, MAX_LEN, device="cpu")
    lt, ct = tdense.prefill(model, cfg_t,
                            {k: torch.from_numpy(v) for k, v in batch.items()},
                            ct)
    _close(lt, lj)
    cj = j_to_paged(cfg_j, cj, page_size=4, page_dtype="int8")
    ct = to_paged(cfg_t, ct, page_size=4, page_dtype="int8")
    assert ct["k_pages"].dtype == torch.int8
    tok = np_(lj).argmax(-1)[:, None].astype(np.int32)
    for _ in range(6):
        lj, cj = jdense.decode(params, cfg_j, {"token": jnp.asarray(tok)}, cj)
        lt, ct = tdense.decode(model, cfg_t, {"token": torch.from_numpy(tok)}, ct)
        _close(lt, lj)
        tok = np_(lj).argmax(-1)[:, None].astype(np.int32)
