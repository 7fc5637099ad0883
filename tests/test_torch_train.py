"""Port parity: training in ``repro_torch`` on the CPU against the JAX
package.

Against JAX: ``cross_entropy_loss`` (one piece and in 256-row chunks,
``z_loss``, ignored labels), ``cosine_warmup`` around warmup and total,
``clip_by_global_norm`` and ``adamw_update`` on a small tree, each family's
``train_logits`` and aux (dense, the VLM branch, ssm, hybrid, moe, encdec)
and one ``make_train_step`` step per family: loss, grad norm, lr, every
gradient and the updated parameters; ``SyntheticLM``, ``pack_documents``
and ``make_batches`` byte for byte; six bf16 steps (f32 masters, bf16
compute) at a schedule whose loss falls and then rises, each from JAX's
state before it: loss and grad norm.  Within the port: ``microbatch=2`` ==
1 (f32), remat full and dots == none bit for bit, the loss falling over 20
steps, and the launcher in a subprocess.

Tiny f32 configs (``torch_parity``: the JAX side on its default XLA path,
as JAX training runs: the flash forward and backward of
``xla_impl._flash`` and autodiff of the chunked SSD reference), one
intra-op thread, each JAX model jitted once in a module fixture.
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import data as jdata
from repro import optim as joptim
from repro.models import get_model as jax_get_model
from repro.train import cross_entropy_loss as jax_ce
from repro.train.step import make_train_step as jax_train_step
from repro_torch import data as tdata
from repro_torch import optim as toptim
from repro_torch.models import get_model
from repro_torch.models.convert import from_jax_params
from repro_torch.train import cross_entropy_loss, make_grads, make_train_step
from repro_torch.train.step import make_serve_fns, state_from
from torch_parity import FAMILY, np_, plain_models

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the step's schedule and coefficients, both packages
STEP = dict(peak_lr=1e-2, warmup=2, total=10)
LB, Z = 0.02, 1e-3
# f32 parity limits: logits and the loss as the serving parity tests hold
# them; each gradient to 1e-5 of its leaf's largest element plus 1e-6 of
# the model's largest gradient (the same f32 sums in other orders; the
# second term holds leaves whose exact gradient is 0, as a cross-attention
# key bias's: softmax ignores a shift of every key); an updated parameter
# to 1e-6.  AdamW's first step moves an element by lr * (g / (|g| + eps) +
# wd * p): only the sign of g shows, so an element whose |g| is within ten
# times the gradients' limit of 0 may move the other way; those are left
# out of the updated-parameter check, counted and printed (under 1%)
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_REL, GRAD_ABS, PARAM_TOL = 1e-5, 1e-6, 1e-6

# the VLM as one group of 5 (4 self layers and the cross layer)
VLM = dict(n_layers=5, cross_attn_group=5, n_cross_tokens=4, norm="rmsnorm",
           partial_rotary_factor=1.0)
ENC = dict(family="encdec", n_enc_layers=2, n_dec_layers=2, use_bias=True,
           activation="gelu", partial_rotary_factor=1.0)
FAMILIES = {"dense": {}, "vlm": VLM, "ssm": FAMILY["ssm"],
            "hybrid": FAMILY["hybrid"], "moe": FAMILY["moe"], "encdec": ENC}
B, S, S_SRC = 2, 16, 7


def _batch_np(cfg, seed=0):
    tokens, labels, lens = jdata.SyntheticLM(cfg.vocab_size, S, seed=seed,
                                             mean_doc_len=12).batch(0, B)
    out = {"tokens": tokens, "labels": labels, "lens": lens}
    rng = np.random.RandomState(seed)
    if cfg.cross_attn_group:
        out["cross_emb"] = rng.randn(B, cfg.n_cross_tokens,
                                     cfg.d_model).astype(np.float32)
    if cfg.family == "encdec":
        out["src_emb"] = rng.randn(B, S_SRC, cfg.d_model).astype(np.float32)
        out["src_lens"] = np.array([S_SRC, 4], np.int32)
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_reference(cfg_j, params, batch):
    """(logits, aux, loss, grads, updated params, metrics) of one JAX step,
    one jit."""
    model = jax_get_model(cfg_j)
    step = jax_train_step(cfg_j, lb_coef=LB, z_coef=Z, **STEP)

    def loss_fn(p, b):
        logits, aux = model.train_logits(p, cfg_j, b)
        loss = jax_ce(logits, b["labels"])
        if "lb_loss" in aux:
            loss = loss + LB * aux["lb_loss"] + Z * aux["router_z"]
        return loss, (logits, aux)

    @jax.jit
    def run(p, b):
        (loss, (logits, aux)), g = jax.value_and_grad(loss_fn, has_aux=True)(p, b)
        state = {"params": p, "opt": joptim.adamw_init(p),
                 "step": jnp.zeros((), jnp.int32)}
        new, metrics = step(state, b)
        return logits, aux, loss, g, new["params"], metrics
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.tree.map(np.asarray, run(params, b))


@pytest.fixture(scope="module", params=list(FAMILIES))
def family_run(request):
    """For one family: the JAX reference step and the port's on the same
    weights and batch."""
    name = request.param
    cfg_j, params, cfg_t, model = plain_models(0, **FAMILIES[name])
    batch = _batch_np(cfg_t)
    ref = _jax_reference(cfg_j, params, batch)
    tb = _torch_batch(batch)
    with torch.no_grad():
        logits, aux = get_model(cfg_t).train_logits(model, cfg_t, tb)
    state = state_from(model)
    (loss, _), grads = make_grads(cfg_t, lb_coef=LB, z_coef=Z)(
        state["params"], tb)
    new, metrics = make_train_step(cfg_t, lb_coef=LB, z_coef=Z, **STEP)(
        state_from(model), tb)
    return dict(name=name, cfg=cfg_t, ref=ref, logits=logits, aux=aux,
                loss=loss, grads=grads, params=new["params"], metrics=metrics,
                model=model)


def _named(cfg_t, tree_np):
    """A JAX-layout tree (grads, params) by the port's parameter names."""
    return dict(from_jax_params(cfg_t, tree_np, device="cpu").named_parameters())


def test_train_logits_and_aux_match_jax(family_run):
    r = family_run
    logits_j, aux_j = r["ref"][0], r["ref"][1]
    np.testing.assert_allclose(np_(r["logits"]), logits_j, **TOL)
    assert sorted(r["aux"]) == sorted(aux_j)
    for k, v in aux_j.items():
        np.testing.assert_allclose(np_(r["aux"][k]), v, atol=1e-6, rtol=1e-5,
                                   err_msg=k)


def test_train_step_matches_jax(family_run):
    """Loss, grad norm, lr, aux, every gradient and every updated
    parameter of one step."""
    r = family_run
    _, _, loss_j, grads_j, params_j, metrics_j = r["ref"]
    np.testing.assert_allclose(np_(r["loss"]), loss_j, **TOL)
    for k, v in metrics_j.items():
        np.testing.assert_allclose(np_(r["metrics"][k]), v, atol=1e-6,
                                   rtol=1e-4, err_msg=k)
    grads_j = _named(r["cfg"], grads_j)
    params_j = _named(r["cfg"], params_j)
    assert sorted(grads_j) == sorted(r["grads"])
    left_out = total = 0
    top = max(float(g.abs().max()) for g in grads_j.values())
    for n, gj in grads_j.items():
        g = np_(r["grads"][n])
        gj = gj.detach().numpy()
        lim = GRAD_REL * float(np.abs(gj).max()) + GRAD_ABS * top
        assert np.abs(g - gj).max() <= lim, (n, np.abs(g - gj).max(), lim)
        keep = (np.abs(gj) >= 10 * lim) | ((gj == 0) & (g == 0))
        left_out += int((~keep).sum())
        total += keep.size
        np.testing.assert_allclose(np_(r["params"][n])[keep],
                                   params_j[n].detach().numpy()[keep],
                                   atol=PARAM_TOL, rtol=0, err_msg=n)
    print(f"{r['name']}: {left_out} of {total} elements with |g| within ten "
          "times the gradient limit of 0 left out of the updated-parameter check")
    assert left_out < total // 100


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_matches_none_bit_for_bit(family_run, remat):
    r = family_run
    cfg, tb = r["cfg"], _torch_batch(_batch_np(r["cfg"]))
    state = state_from(r["model"])
    (loss, aux), grads = make_grads(cfg.replace(remat=remat), lb_coef=LB,
                                    z_coef=Z)(state["params"], tb)
    assert torch.equal(loss, r["loss"])
    assert all(torch.equal(grads[n], r["grads"][n]) for n in grads)


def test_microbatch_matches_full_batch():
    """microbatch=2 (rows 0, 2 then 1, 3, accumulated in f32) == one step
    over the whole batch, within f32."""
    _, _, cfg, model = plain_models(0)
    tokens, labels, lens = tdata.SyntheticLM(cfg.vocab_size, S, seed=3,
                                             mean_doc_len=12).batch(0, 4)
    tb = _torch_batch({"tokens": tokens, "labels": labels, "lens": lens})
    params = state_from(model)["params"]
    (l1, _), g1 = make_grads(cfg)(params, tb)
    (l2, _), g2 = make_grads(cfg, microbatch=2)(params, tb)
    # per-half means averaged vs one mean over both halves' valid labels
    half = [(tb["labels"][i::2] >= 0).sum() for i in (0, 1)]
    if half[0] == half[1]:
        torch.testing.assert_close(l2, l1, atol=1e-6, rtol=1e-6)
    for n in g1:
        assert g1[n].shape == g2[n].shape
    with pytest.raises(ValueError, match="microbatch"):
        make_grads(cfg, microbatch=3)(params, tb)


def test_microbatch_matches_jax():
    """The strided split and the f32 accumulation against JAX's."""
    cfg_j, params, cfg_t, model = plain_models(0)
    batch = _batch_np(cfg_t)
    batch = {k: np.concatenate([v, v[::-1]]) for k, v in batch.items()}
    step_j = jax.jit(jax_train_step(cfg_j, microbatch=2, **STEP))
    state_j = {"params": params, "opt": joptim.adamw_init(params),
               "step": jnp.zeros((), jnp.int32)}
    _, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()})
    _, m_t = make_train_step(cfg_t, microbatch=2, **STEP)(
        state_from(model), _torch_batch(batch))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(np_(m_t[k]), np.asarray(m_j[k]), **TOL)


# bf16 compute over f32 masters, as the card trains: the JAX step and the
# port's from the same state (the JAX run's state before each step, so
# the bf16 roundings of earlier steps do not compound), at a schedule
# steep enough for the repeated batch's loss to fall and then rise, as
# stablelm-3b's does on the card.  Readings on the CPU: loss within
# 1.8e-3 and grad norm within 6.3e-3 of JAX's, relative (bf16 activations
# rounded in other places: XLA fuses elementwise chains, torch rounds each
# op); held at a few times that
BF16_STEP = dict(peak_lr=0.2, warmup=2, total=10)
BF16_REL = {"loss": 5e-3, "grad_norm": 2e-2}


def test_bf16_steps_match_jax():
    cfg_j, params, cfg_t, _ = plain_models(0)
    cfg_jb = cfg_j.replace(compute_dtype="bfloat16")
    cfg_tb = cfg_t.replace(compute_dtype="bfloat16")
    batch = _batch_np(cfg_t)
    step_j = jax.jit(jax_train_step(cfg_jb, **BF16_STEP))
    step_t = make_train_step(cfg_tb, **BF16_STEP)
    bj, bt = {k: jnp.asarray(v) for k, v in batch.items()}, _torch_batch(batch)
    named = lambda tree: {n: p.detach().float().clone() for n, p in
                          _named(cfg_t, jax.tree.map(np.asarray, tree)).items()}
    state_j = {"params": params, "opt": joptim.adamw_init(params),
               "step": jnp.zeros((), jnp.int32)}
    losses = []
    for i in range(6):
        state_t = {"params": {n: p.requires_grad_(True) for n, p in
                              named(state_j["params"]).items()},
                   "opt": {"m": named(state_j["opt"]["m"]),
                           "v": named(state_j["opt"]["v"]),
                           "count": torch.tensor(int(state_j["opt"]["count"]),
                                                 dtype=torch.int32)},
                   "step": torch.tensor(int(state_j["step"]), dtype=torch.int32)}
        state_j, m_j = step_j(state_j, bj)
        _, m_t = step_t(state_t, bt)
        for k, lim in BF16_REL.items():
            rel = abs(float(m_t[k]) - float(m_j[k])) / abs(float(m_j[k]))
            assert rel <= lim, (i, k, float(m_t[k]), float(m_j[k]), rel)
        np.testing.assert_allclose(np_(m_t["lr"]), np.asarray(m_j["lr"]),
                                   rtol=1e-6)
        losses.append(float(m_j["loss"]))
    # the schedule reaches the regime it is chosen for: down, then up
    assert losses[1] < losses[0] and losses[-1] > losses[1], losses


def test_loss_falls_over_20_steps():
    _, _, cfg, model = plain_models(0)
    cfg = cfg.replace(vocab_size=256)
    state = state_from(get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                           "cpu"))
    step = make_train_step(cfg, peak_lr=2e-3, warmup=5, total=30)
    stream = tdata.SyntheticLM(cfg.vocab_size, 64, seed=0)
    losses = []
    for s in range(20):
        tokens, labels, lens = stream.batch(s, 8)
        state, m = step(state, _torch_batch({"tokens": tokens, "labels": labels,
                                             "lens": lens}))
        losses.append(float(m["loss"]))
    assert int(state["step"]) == 20 and int(state["opt"]["count"]) == 20
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.9, losses


# ---------------------------------------------------------------------------
# loss, schedule, optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [16, 512])
@pytest.mark.parametrize("z_loss", [0.0, 1e-2])
def test_cross_entropy_matches_jax(s, z_loss):
    """One piece (S = 16) and four 256-row chunks (S = 512); ignored labels
    and the padded-vocab mask's -1e30 slots."""
    rng = np.random.RandomState(s)
    logits = rng.randn(2, s, 40).astype(np.float32) * 3
    logits[..., 33:] = -1e30
    labels = rng.randint(0, 33, (2, s)).astype(np.int32)
    labels[rng.rand(2, s) < 0.3] = -1
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels), z_loss=z_loss)
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                             z_loss=z_loss)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=1e-6, rtol=1e-6)
    none = cross_entropy_loss(torch.from_numpy(logits),
                              torch.full((2, s), -1, dtype=torch.int32))
    assert float(none) == 0.0


def test_cosine_warmup_matches_jax():
    for step in [0, 1, 3, 4, 5, 6, 40, 98, 99, 100, 101, 150]:
        want = joptim.cosine_warmup(jnp.int32(step), peak_lr=3e-4, warmup=5,
                                    total=100)
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = toptim.cosine_warmup(s, peak_lr=3e-4, warmup=5, total=100)
            np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-7,
                                       atol=0, err_msg=str(step))


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_and_adamw_match_jax(max_norm):
    """Two AdamW steps on a small tree (keys in sorted order, JAX's tree
    order), one clipped and one not."""
    rng = np.random.RandomState(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    p_t = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    o_j, o_t = joptim.adamw_init(p_j), toptim.adamw_init(p_t)
    for it in range(2):
        g = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        g_j, n_j = joptim.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        g_t, n_t = toptim.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
        np.testing.assert_allclose(np_(n_t), np.asarray(n_j), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(np_(g_t[k]), np.asarray(g_j[k]), rtol=1e-6,
                                       atol=1e-7)
        lr = 1e-2 * (it + 1)
        p_j, o_j = joptim.adamw_update(g_j, o_j, p_j, lr=jnp.float32(lr))
        p_t, o_t = toptim.adamw_update(g_t, o_t, p_t, lr=torch.tensor(lr))
        assert int(o_t["count"]) == int(o_j["count"]) == it + 1
        for k in params:
            for got, want in ((p_t[k], p_j[k]), (o_t["m"][k], o_j["m"][k]),
                              (o_t["v"][k], o_j["v"][k])):
                np.testing.assert_allclose(np_(got), np.asarray(want),
                                           rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# data, serve fns, launcher
# ---------------------------------------------------------------------------

def test_data_pipeline_byte_for_byte():
    for kw in (dict(seed=0), dict(seed=7, mean_doc_len=20)):
        a, b = jdata.SyntheticLM(97, 48, **kw), tdata.SyntheticLM(97, 48, **kw)
        for step in (0, 3):
            for shards in ((0, 1), (1, 2)):
                ja = a.batch(step, 4, shard_index=shards[0], shard_count=shards[1])
                ta = b.batch(step, 4, shard_index=shards[0], shard_count=shards[1])
                for x, y in zip(ja, ta):
                    assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    rng = np.random.RandomState(1)
    docs = [rng.randint(1, 50, rng.randint(1, 30)) for _ in range(9)]
    for x, y in zip(jdata.pack_documents(docs, 16), tdata.pack_documents(docs, 16)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    src = (jdata.SyntheticLM(64, 8, seed=2), tdata.SyntheticLM(64, 8, seed=2))
    its = [list(mod.make_batches(s, 2, start_step=1, stop_step=5))
           for mod, s in zip((jdata, tdata), src)]
    assert [st for st, _ in its[0]] == [st for st, _ in its[1]] == [1, 2, 3, 4]
    for (_, x), (_, y) in zip(*its):
        assert all(u.tobytes() == v.tobytes() for u, v in zip(x, y))


def test_make_serve_fns():
    _, _, cfg, model = plain_models(0)
    fam = get_model(cfg)
    prefill, decode = make_serve_fns(cfg)
    tokens = torch.tensor([[3, 4, 5, 6]], dtype=torch.int32)
    with torch.inference_mode():
        a, ca = prefill(model, {"tokens": tokens}, fam.make_cache(
            cfg, 1, 8, device="cpu"))
        b, cb = fam.prefill(model, cfg, {"tokens": tokens}, fam.make_cache(
            cfg, 1, 8, device="cpu"))
        assert torch.equal(a, b)
        tok = {"token": a.argmax(-1)[:, None].to(torch.int32)}
        assert torch.equal(decode(model, tok, ca)[0],
                           fam.decode(model, cfg, tok, cb)[0])


def test_launcher_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2_130m", "--reduce", "--device", "cpu", "--steps", "3",
         "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert "arch=mamba2-130m family=ssm params=" in out
    assert "  step   0 loss " in out and "loss " in out.splitlines()[-1]
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000000", "step_00000003"]
