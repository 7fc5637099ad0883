"""Training on a ``data x model`` mesh (``train.step`` with ``mesh=``) on
gloo CPU ranks started by ``launch.mesh.run_ranks``, against JAX's sharded
train step and the one-device steps.

(i) On data 2 x model 2, for dense, the VLM branch, moe (``moe_groups=2``:
one dispatch group per data rank), ssm, hybrid and encdec, from the
weights of JAX's ``init(PRNGKey(0))``: the first step's gradients
(gathered whole), then three steps' loss and grad norm, and the params and
AdamW moments after them, against the port's one-device step and against
JAX's own step jitted with ``in_shardings`` from ``tree_shardings`` under
``use_mesh_rules`` on a 2 x 2 ``jax.sharding.Mesh`` of 4 forced host
devices (one subprocess).  (ii) ``moe_ffn`` at ``moe_groups`` 2 and 4 on
one device against JAX's, with and without dropped assignments.  (iii)
``microbatch=2`` on the mesh against 1.  (iv) A checkpoint saved on 2 x 2
restores bit for bit onto 1 x 2, 4 x 1 and one device, and JAX's
``restore_checkpoint`` reads it; a fault mid-run resumes to the
uninterrupted run's bits, and a run restarted on 1 x 2 from the 2 x 2
checkpoint to its loss.  (v) ``launch.train --mesh 2x1``.

Tolerances (f32: a row-parallel product sums each model rank's partial
product, and the token mean, the FSDP gradient sum and the global norm
add in other orders than one device does, so nothing here is bit for
bit but the restore):

* loss and grad norm: 1e-5 relative;
* a first step's gradient: 1e-5 of its leaf's largest element plus 1e-6
  of the model's largest (the second term holds leaves whose exact
  gradient is 0, such as encdec's cross-attention key bias, whose every
  element is rounding noise);
* the moments after three steps: ten times that for ``m`` (a sum of the
  steps' gradients), and for ``v`` ten times 2e-5 of its leaf's largest
  element plus 1e-12.  The second and third steps take their gradients at
  parameters that already differ by the elements below, so the moments
  carry those differences as well as the rounding (measured: up to 5.3
  times the one-step limits, hybrid and encdec, whose parameters differ
  most);
* a parameter: 1e-6, but for at most 0.1% of the elements (counted and
  printed), each held within twice the learning rates' sum.  AdamW moves
  an element by lr * m / (sqrt(v) + eps), whose size is about lr whatever
  the gradient's: where the steps' gradients nearly cancel in ``m``, or
  are near 0, the gradients' rounding moves such an element by up to a
  whole update, as far as 2 lr a step where its sign flips (the one-step
  parity of ``test_torch_train.py`` leaves such elements out for that
  reason; over three steps their number is what is held).
"""

import concurrent.futures
import os
import pickle
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.models import ModelConfig as JaxConfig
from repro.models import get_model as jax_get_model
from repro.models import moe as jmoe
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.data import SyntheticLM
from repro_torch.dist import sharding as SH
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import ModelConfig
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import (_copy_module, named_from_jax,
                                        state_from_jax)
from repro_torch.optim import adamw_init
from repro_torch.runtime import FaultTolerantLoop
from repro_torch.train import step as TS

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# test_train_integration.py's CFG, the launcher's reduced SSM and MoE
# sizes, and the family twins of test_torch_train.py
BASE = dict(name="it", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, param_dtype="float32",
            compute_dtype="float32")
_SSM = dict(norm="rmsnorm", ssm_state=16, ssm_headdim=16, ssm_chunk=16)
FAMILIES = {
    "dense": {},
    "vlm": dict(n_layers=5, cross_attn_group=5, n_cross_tokens=4,
                norm="rmsnorm"),
    "moe": dict(family="moe", norm="rmsnorm", qk_norm=True, first_k_dense=1,
                n_experts=8, top_k=2, moe_groups=2),
    "ssm": dict(_SSM, family="ssm"),
    "hybrid": dict(_SSM, family="hybrid", n_layers=3, shared_attn_period=2),
    "encdec": dict(family="encdec", n_enc_layers=2, n_dec_layers=2,
                   use_bias=True, activation="gelu"),
}
MESH = (2, 2)
AXES = ("data", "model")
B, S, S_SRC, STEPS = 4, 16, 7, 3
STEP = dict(peak_lr=2e-3, warmup=1, total=10)
LB, Z = 0.02, 1e-3
REL = 1e-5                       # loss, grad norm
GRAD_REL, GRAD_ABS = 1e-5, 1e-6  # a gradient: of its leaf, of the model
V_REL, V_ABS = 2e-5, 1e-12
MOMENTS = 10                     # the moments after STEPS steps
PARAM_TOL, PARAM_OUT = 1e-6, 1e-3
# the checkpoint legs: dense on 2 x 2, saved after SAVE_AT of RUN_TO steps
SAVE_AT, RUN_TO, FAULT_AT = 2, 5, 3


def _cfg(fam):
    return dict(BASE, **FAMILIES[fam])


def _batches(cfg, n=STEPS, b=B, seed=0):
    """Step i's batch as numpy: ``SyntheticLM`` rows, and the VLM's image or
    the encdec encoder inputs from ``RandomState(i)``."""
    data = SyntheticLM(cfg.vocab_size, S, seed=seed, mean_doc_len=12)
    out = []
    for i in range(n):
        tokens, labels, lens = data.batch(i, b)
        x = {"tokens": tokens, "labels": labels, "lens": lens}
        rng = np.random.RandomState(i)
        if cfg.cross_attn_group:
            x["cross_emb"] = rng.randn(b, cfg.n_cross_tokens,
                                       cfg.d_model).astype(np.float32)
        if cfg.family == "encdec":
            x["src_emb"] = rng.randn(b, S_SRC, cfg.d_model).astype(np.float32)
            x["src_lens"] = np.array([S_SRC, 4, 5, S_SRC][:b], np.int32)
        out.append(x)
    return out


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def _train(cfg, state, batches, mesh=None):
    """(step-0 gradients, each step's metrics, the final state), gradients
    and state whole (gathered over ``mesh``), as numpy."""
    grads_of = TS.make_grads(cfg, lb_coef=LB, z_coef=Z, mesh=mesh)
    _, grads = grads_of(state["params"], _tb(batches[0]))
    step = TS.make_train_step(cfg, lb_coef=LB, z_coef=Z, mesh=mesh, **STEP)
    metrics = []
    for b in batches:
        state, m = step(state, _tb(b))
        metrics.append({k: float(v) for k, v in m.items()})
    if mesh is not None:
        sh = TS.state_shardings(cfg, mesh)
        grads = {n: SH.gather_whole(g, sh["params"][n], mesh)
                 for n, g in grads.items()}
        state = TS.gather_state(state, sh, mesh)
    return _np(grads), metrics, _np(state)


def _fresh(init):
    """A port state from whole numpy masters (zero moments, step 0)."""
    params = {n: torch.from_numpy(a.copy()).requires_grad_(True)
              for n, a in init.items()}
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def _dense_cfg():
    return ModelConfig(**_cfg("dense"))


def _loop(mesh, ckpt_dir, state, fault_at=None):
    """The dense checkpoint leg's loop to ``RUN_TO`` steps, saving every
    ``SAVE_AT``; a fault injected once at ``fault_at``.  Returns (state,
    history)."""
    cfg = _dense_cfg()
    data = _batches(cfg, n=RUN_TO)
    fired = []

    def fault(s):
        if s == fault_at and not fired:
            fired.append(s)
            raise RuntimeError(f"injected fault at step {s}")

    loop = FaultTolerantLoop(
        TS.make_train_step(cfg, mesh=mesh, **STEP),
        lambda s: _tb(data[s]), ckpt_dir=ckpt_dir, save_every=SAVE_AT,
        mesh=mesh, state_shardings=(None if mesh is None
                                    else TS.state_shardings(cfg, mesh)))
    return loop.run(state, RUN_TO, fault_injector=fault)


def _mesh_rank(mesh, init, ckpt_root):
    """One rank of the 2 x 2 mesh run: every family's three steps (i), the
    microbatched step (iii), the dense checkpoint legs (iv): a clean run
    saving into ``ckpt_root/clean`` and one with an injected fault."""
    out = {"families": {}}
    for fam in FAMILIES:
        cfg = ModelConfig(**_cfg(fam))
        state = TS.shard_state(_fresh(init[fam]),
                               TS.state_shardings(cfg, mesh), mesh)
        out["families"][fam] = _train(cfg, state, _batches(cfg), mesh)
    # (iii) microbatch=2 == 1, test_train_integration's data
    cfg = _dense_cfg()
    sh = TS.state_shardings(cfg, mesh)
    tokens, labels, lens = SyntheticLM(cfg.vocab_size, 32, seed=1).batch(0, 8)
    batch = _tb({"tokens": tokens, "labels": labels, "lens": lens})
    for mb in (1, 2):
        state = TS.shard_state(_fresh(init["dense"]), sh, mesh)
        state, m = TS.make_train_step(cfg, microbatch=mb, mesh=mesh)(state,
                                                                     batch)
        out[f"micro{mb}"] = (float(m["loss"]),
                             _np(TS.gather_state(state, sh, mesh)["params"]))
    # (iv) the checkpoint legs
    for leg, fault_at in (("clean", None), ("faulty", FAULT_AT)):
        state = TS.shard_state(_fresh(init["dense"]), sh, mesh)
        state, hist = _loop(mesh, os.path.join(ckpt_root, leg), state,
                            fault_at)
        out[leg] = (hist, _np(TS.gather_state(state, sh, mesh)))
    return out


def _remesh_rank(mesh, init, ckpt_dir, resume_dir):
    """One rank of a 1 x 2 or 4 x 1 mesh run: the 2 x 2 checkpoint at
    ``SAVE_AT`` restored onto this mesh and gathered whole; on 1 x 2 also
    the dense loop resumed from it (``resume_dir``, a copy) to
    ``RUN_TO``."""
    cfg = _dense_cfg()
    sh = TS.state_shardings(cfg, mesh)
    like = TS.shard_state(_fresh(init["dense"]), sh, mesh)
    state, step = restore_checkpoint(ckpt_dir, like, step=SAVE_AT,
                                     shardings=sh, mesh=mesh)
    out = {"step": step, "state": _np(TS.gather_state(state, sh, mesh))}
    if resume_dir is not None:
        out["resumed"] = _loop(mesh, resume_dir, like)[1]
    return out


JAX_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.dist import sharding as SH
from repro.models import ModelConfig, get_model
from repro.optim import adamw_init
from repro.train import cross_entropy_loss
from repro.train.step import abstract_state, make_train_step

with open(sys.argv[1], "rb") as f:
    runs = pickle.load(f)
# jax.make_mesh's axes are explicit under jax 0.9 and the embedding gather
# refuses them: an Auto mesh, as the dry run builds it on a TPU
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out = {}
for fam, run in runs.items():
    cfg = ModelConfig(**run["cfg"])
    model = get_model(cfg)
    params, _ = model.init(jax.random.PRNGKey(0), cfg)
    state = {"params": params, "opt": adamw_init(params),
             "step": jnp.zeros((), jnp.int32)}
    _, axes = abstract_state(cfg)
    batches = [jax.tree.map(jnp.asarray, b) for b in run["batches"]]

    def loss_fn(p, b):
        logits, aux = model.train_logits(p, cfg, b)
        loss = cross_entropy_loss(logits, b["labels"])
        if "lb_loss" in aux:
            loss = loss + run["lb"] * aux["lb_loss"] + run["z"] * aux["router_z"]
        return loss

    with SH.use_mesh_rules(mesh):
        state_sh = SH.tree_shardings(state, axes, mesh)
        batch_sh = SH.tree_shardings(batches[0], SH.batch_axes_for(batches[0]),
                                     mesh)
        grad_fn = jax.jit(jax.grad(loss_fn),
                          in_shardings=(state_sh["params"], batch_sh))
        step = jax.jit(make_train_step(cfg, lb_coef=run["lb"],
                                       z_coef=run["z"], **run["step"]),
                       in_shardings=(state_sh, batch_sh),
                       out_shardings=(state_sh, None))
        grads = grad_fn(params, batches[0])
        state = jax.device_put(state, state_sh)
        metrics = []
        for b in batches:
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
    out[fam] = jax.tree.map(np.asarray, (grads, metrics, state))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("jax sharded train steps OK")
"""


#: JAX's sharded steps run in three subprocesses beside the ranks, a family
#: group each
JAX_GROUPS = (("dense", "ssm"), ("vlm", "hybrid"), ("moe", "encdec"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run's results: JAX's sharded steps (subprocesses, run
    beside the ranks), the one-device port's, the 2 x 2 ranks', and the
    restores onto 1 x 2 and 4 x 1 (two mesh runs at once)."""
    d = tmp_path_factory.mktemp("mesh_train")
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", str(d))}
    procs = []
    for i, fams in enumerate(JAX_GROUPS):
        with open(d / f"jax_in{i}.pkl", "wb") as f:
            pickle.dump({fam: dict(cfg=_cfg(fam), lb=LB, z=Z, step=STEP,
                                   batches=_batches(ModelConfig(**_cfg(fam))))
                         for fam in fams}, f)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT, str(d / f"jax_in{i}.pkl"),
             str(d / f"jax_out{i}.pkl")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT))
    try:
        init, one = {}, {}
        for fam in FAMILIES:
            cfg_j = JaxConfig(**_cfg(fam))
            params, _ = jax_get_model(cfg_j).init(jax.random.PRNGKey(0), cfg_j)
            cfg = ModelConfig(**_cfg(fam))
            init[fam] = _np(named_from_jax(cfg, jax.tree.map(np.asarray, params),
                                           device="cpu"))
            one[fam] = _train(cfg, _fresh(init[fam]), _batches(cfg))
        ckpt = str(d / "ckpt")
        mesh = run_ranks(_mesh_rank, MESH, AXES, init, ckpt, device="cpu",
                         timeout=300)
        clean = os.path.join(ckpt, "clean")
        shutil.copytree(clean, d / "resume")
        # the resumed loop must start from SAVE_AT: later steps go
        for name in os.listdir(d / "resume"):
            if name != f"step_{SAVE_AT:08d}":
                shutil.rmtree(d / "resume" / name)
        remeshes = {(1, 2): str(d / "resume"), (4, 1): None}
        with concurrent.futures.ThreadPoolExecutor(len(remeshes)) as ex:
            futs = {shape: ex.submit(run_ranks, _remesh_rank, shape, AXES,
                                     init, clean, resume, device="cpu",
                                     timeout=300)
                    for shape, resume in remeshes.items()}
            remesh = {shape: f.result() for shape, f in futs.items()}
        jx = {}
        for i, p in enumerate(procs):
            log, _ = p.communicate(timeout=300)
            assert p.returncode == 0, log
            with open(d / f"jax_out{i}.pkl", "rb") as f:
                jx.update(pickle.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return dict(jax=jx, one=one, mesh=mesh, remesh=remesh, init=init,
                ckpt=clean)


def _named(fam, tree):
    return _np(named_from_jax(ModelConfig(**_cfg(fam)), tree, device="cpu"))


def _grad_limits(grads):
    top = max(float(np.abs(g).max()) for g in grads.values())
    return {n: GRAD_REL * float(np.abs(g).max()) + GRAD_ABS * top
            for n, g in grads.items()}


def _hold(fam, got, want, what):
    """``got`` (grads, metrics, state) within the module's tolerances of
    ``want``."""
    g, m, st = got
    gw, mw, sw = want
    assert sorted(g) == sorted(gw)
    for n, lim in _grad_limits(gw).items():
        err = float(np.abs(g[n] - gw[n]).max())
        assert err <= lim, (fam, what, "grad", n, err, lim)
    for i, (a, b) in enumerate(zip(m, mw)):
        assert sorted(a) == sorted(b), (fam, what, a, b)
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= REL * abs(b[k]), (fam, what, i, k, a[k],
                                                         b[k])
        for k in b:
            assert a[k] == pytest.approx(b[k], rel=REL, abs=1e-7), (
                fam, what, i, k)
    m_lim = _grad_limits(sw["opt"]["m"])
    flip = 2 * sum(b["lr"] for b in mw)
    out = total = 0
    for n, lim in m_lim.items():
        mt, mr = st["opt"]["m"][n], sw["opt"]["m"][n]
        assert np.abs(mt - mr).max() <= MOMENTS * lim, (fam, what, "m", n)
        vt, vr = st["opt"]["v"][n], sw["opt"]["v"][n]
        assert np.abs(vt - vr).max() <= MOMENTS * (
            V_REL * np.abs(vr).max() + V_ABS), (fam, what, "v", n)
        err = np.abs(st["params"][n] - sw["params"][n])
        assert err.max() <= flip, (fam, what, "param", n, err.max(), flip)
        out += int((err > PARAM_TOL).sum())
        total += err.size
    assert int(st["step"]) == int(sw["step"]) == STEPS
    assert int(st["opt"]["count"]) == int(sw["opt"]["count"]) == STEPS
    print(f"{fam} vs {what}: {out} of {total} parameters outside "
          f"{PARAM_TOL:g}")
    assert out <= PARAM_OUT * total, (fam, what, out, total)


def _jax_run(runs, fam):
    """JAX's (grads, metrics, state) by the port's names (the state through
    ``convert.state_from_jax``)."""
    grads, metrics, state = runs["jax"][fam]
    state = state_from_jax(ModelConfig(**_cfg(fam)), state, device="cpu")
    return _named(fam, grads), metrics, _np(state)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_mesh_step_matches_one_device(runs, fam):
    """(i) The 2 x 2 step against the port's one-device step, and every
    rank's metrics the same bits."""
    ranks = runs["mesh"]
    for r in ranks[1:]:
        assert r["families"][fam][1] == ranks[0]["families"][fam][1]
    _hold(fam, ranks[0]["families"][fam], runs["one"][fam], "one device")


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_mesh_step_matches_jax_sharded_step(runs, fam):
    """(i) The 2 x 2 step against JAX's step sharded on a 2 x 2 mesh, and
    the one-device port's against it too."""
    want = _jax_run(runs, fam)
    _hold(fam, runs["mesh"][0]["families"][fam], want, "jax sharded")
    _hold(fam, runs["one"][fam], want, "jax sharded (one-device port)")


def test_microbatch_on_the_mesh(runs):
    """(iii) ``microbatch=2`` == 1 on the mesh, within the tolerance of
    JAX's ``test_microbatched_grads_match_full_batch``."""
    r = runs["mesh"][0]
    (l1, p1), (l2, p2) = r["micro1"], r["micro2"]
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    for n in p1:
        np.testing.assert_allclose(p2[n], p1[n], rtol=2e-4, atol=2e-6,
                                   err_msg=n)


def _bits_equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_bits_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_checkpoint_restores_on_any_mesh(runs):
    """(iv) The 2 x 2 checkpoint restores bit for bit onto 1 x 2, 4 x 1 and
    one device (gathered whole), and JAX's ``restore_checkpoint`` reads
    it."""
    cfg = _dense_cfg()
    like = _fresh(runs["init"]["dense"])
    whole, step = restore_checkpoint(runs["ckpt"], like, step=SAVE_AT)
    assert step == SAVE_AT
    whole = _np(whole)
    # the saved state is the clean run's after SAVE_AT steps: step and count
    assert int(whole["step"]) == int(whole["opt"]["count"]) == SAVE_AT
    for shape, ranks in runs["remesh"].items():
        for r in ranks:
            assert r["step"] == SAVE_AT
            assert _bits_equal(r["state"], whole), shape
    like_np = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), whole)
    back, step = jax_restore(runs["ckpt"], like_np, step=SAVE_AT)
    assert step == SAVE_AT
    assert _bits_equal(jax.tree.map(np.asarray, back), whole)
    assert sorted(back["params"]) == sorted(n for n, _ in
                                            TS.skeleton(cfg).named_parameters())


def test_fault_and_remesh_resume(runs):
    """(iv) The injected fault at step ``FAULT_AT`` on 2 x 2 restores and
    ends on the uninterrupted run's bits; the run restarted on 1 x 2 from
    the 2 x 2 checkpoint at ``SAVE_AT`` resumes at that step and ends
    within the loss tolerance of the uninterrupted run."""
    for r in runs["mesh"]:
        (h_clean, s_clean), (h_fault, s_fault) = r["clean"], r["faulty"]
        assert [s for s, _ in h_clean] == list(range(RUN_TO))
        assert h_fault[-1] == h_clean[-1]
        assert len(h_fault) == RUN_TO + FAULT_AT - FAULT_AT // SAVE_AT * SAVE_AT
        assert _bits_equal(s_fault, s_clean)
    clean = dict(runs["mesh"][0]["clean"][0])
    for r in runs["remesh"][(1, 2)]:
        resumed = r["resumed"]
        assert [s for s, _ in resumed] == list(range(SAVE_AT, RUN_TO))
        for s, loss in resumed:
            assert abs(loss - clean[s]) <= REL * clean[s], (s, loss, clean[s])


def _moe_block(cfg_t, params):
    """The first MoE layer's FFN weights of JAX's params, as numpy."""
    return {k: (np.asarray(v[0]) if not isinstance(v, dict)
                else {kk: np.asarray(vv[0]) for kk, vv in v.items()})
            for k, v in params["blocks"]["moe"].items()}


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("drop", [False, True])
def test_moe_ffn_token_groups_match_jax(groups, drop):
    """(ii) ``moe_ffn`` over ``moe_groups`` dispatch groups on one device
    against JAX's: outputs within f32 and the aux losses; with ``drop`` a
    router skewed towards expert 0 (as ``test_torch_moe.py``'s) overflows
    its capacity in every group and the same fraction of assignments
    drops."""
    kw = dict(_cfg("moe"), moe_groups=groups)
    cfg_j, cfg_t = JaxConfig(**kw), ModelConfig(**kw)
    params, _ = jax_get_model(cfg_j).init(jax.random.PRNGKey(0), cfg_j)
    p_np = _moe_block(cfg_t, params)
    x = np.random.RandomState(groups).randn(4, 16, cfg_t.d_model).astype(
        np.float32)
    if drop:
        p_np["router"] = p_np["router"].copy()
        p_np["router"][:, 0] += 0.1
        x = x + 1.0
    blk = tmoe.MoEFFN(cfg_t, "cpu")
    _copy_module(blk, p_np)
    y_j, m_j = jax.jit(jmoe.moe_ffn, static_argnums=2)(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(x), cfg_j)
    y_t, m_t = tmoe.moe_ffn(blk, torch.from_numpy(x), cfg_t, aux=True)
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j), atol=1e-4, rtol=1e-4)
    for k, v in m_j.items():
        np.testing.assert_allclose(float(m_t[k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert (float(m_j["dropped_frac"]) > 0) == drop


@pytest.mark.parametrize("over,shape,what", [
    (dict(n_heads=4, n_kv_heads=2), {"data": 1, "model": 4},
     "do not cut into 4 whole-head blocks"),
    (dict(act_shard="tp_sp"), {"data": 2, "model": 2}, "tp_sp"),
    ({}, {"pod": 2, "data": 1, "model": 1}, "pod axis"),
])
def test_uncovered_training_meshes_name_item_14(over, shape, what):
    """What training on a mesh leaves out is refused naming its item; an
    ssm model cuts no heads and trains on any model axis."""
    cfg = ModelConfig(**dict(BASE, **over))
    with pytest.raises(NotImplementedError, match="Queue 1 item 14") as e:
        TS.check_train_mesh(cfg, shape)
    assert what in str(e.value)
    TS.check_train_mesh(ModelConfig(**_cfg("ssm")), {"data": 1, "model": 4})


def test_card_bytes_per_rank():
    """``launch.train.card_bytes``: olmoe-1b-7b's 16 bytes a parameter over
    data 2 x model 2 is a quarter a rank but for the leaves "model" leaves
    whole (the routers, 0.03%), so a card of its own would hold it, but the
    four ranks that share one card here hold it all, over the H100's 80
    GB: the launcher refuses it."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    cfg = get_config("olmoe_1b_7b").replace(moe_groups=2)
    shape = {"data": 2, "model": 2}
    whole = T.card_bytes(cfg)
    assert whole == 16 * cfg.param_count() > 80e9
    rank = T.card_bytes(cfg, shape)
    assert whole / 4 < rank < 1.001 * whole / 4 and rank < 80e9
    assert T.card_bytes(cfg, shape, per_card=4) == 4 * rank > 80e9


def test_launcher_mesh_refuses_without_cuda():
    """No fallback: without CUDA, ``--mesh`` starts no rank unless the CPU
    is asked for."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    from repro_torch.launch import train as T
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.main(["--arch", "stablelm_3b", "--reduce", "--mesh", "2x1"])


def test_launcher_mesh_prints_the_jax_lines(tmp_path):
    """(v) ``launch.train --reduce --mesh 2x1 --device cpu`` trains and
    prints the JAX launcher's lines, with the one-device run's losses."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "stablelm_3b", "--reduce", "--device", "cpu", "--steps", "6"]
    procs = [subprocess.Popen(
        argv + extra + ["--ckpt-dir", str(tmp_path / str(i))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for i, extra in enumerate((["--mesh", "2x1"], []))]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, out + err
        outs.append(out.splitlines())
    mesh, one = outs
    assert mesh[0].startswith("arch=stablelm-3b family=dense params=")
    assert mesh[0] == one[0]
    lines = lambda out: [ln for ln in out if ln.startswith("  step ")
                         or ln.startswith("loss ")]
    got, want = lines(mesh), lines(one)
    assert [ln.split()[:2] for ln in got] == [ln.split()[:2] for ln in want]
    assert len(got) == 3 and got[-1].startswith("loss ")
    nums = lambda out: [float(w) for ln in out for w in ln.split()
                        if w.replace(".", "", 1).isdigit() and "." in w]
    np.testing.assert_allclose(nums(got), nums(want), atol=2e-4)
