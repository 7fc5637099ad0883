"""``repro_torch.dist.sharding`` and ``dist.serve`` against the JAX package:
``spec_for`` on every case of ``test_sharding_rules.py``, ``cache_axes`` /
``cache_shardings`` on its serve caches, and at the reference's tiny dense
config (``BASE`` of ``test_sharded_serve.py``: 2 layers, d 64, 4 heads, 2
KV heads) the dense axes tree, every parameter's resolved spec and a dense,
a paged and an int8-paged cache's specs, over meshes (1, 2), (1, 4),
(2, 2) and (2, 4).  The JAX side runs in one subprocess with 16 forced
host devices, as ``test_sharding_rules.py`` runs it.  Then, within the
port: a rank's blocks (``local_slice``) have the shapes of the caches
``local_config`` allocates, ``shard_params`` cuts whole heads, and what
mesh serving leaves out (the kv_seq fallback, moe dispatch groups) is
refused naming ROADMAP Queue 1 item 14.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.dist import serve as DS
from repro_torch.dist import sharding as SH
from repro_torch.launch.mesh import Mesh
from repro_torch.models import ModelConfig, get_model

BASE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=64, param_dtype="float32",
            compute_dtype="float32")
MESHES = ((1, 2), (1, 4), (2, 2), (2, 4))
# (shape, logical axes, mesh shape, mesh axes, rules): test_sharding_rules.py
RULE_CASES = [
    ((256, 512), ("embed", "heads"), (2, 4), ("data", "model"), None),
    ((64, 6), ("embed", "kv_heads"), (2, 4), ("data", "model"), None),
    ((8, 8), ("mlp", "heads"), (2, 4), ("data", "model"), None),
    ((8, 128), ("batch", None), (2, 2, 4), ("pod", "data", "model"), None),
    ((1, 128), ("batch", None), (2, 2, 4), ("pod", "data", "model"), None),
    ((4, 2, 64, 32), ("batch", "act_kv_heads", "kv_seq", None), (2, 4),
     ("data", "model"), None),
    ((4, 4, 64, 32), ("batch", "act_kv_heads", "kv_seq", None), (2, 4),
     ("data", "model"), None),
    ((16, 256, 512), ("layers", "embed", "mlp"), (4,), ("data",), None),
    ((16, 256, 512), ("layers", "embed", "mlp"), (2, 2), ("data", "model"),
     None),
    ((16, 256, 512), ("layers", "embed", "mlp"), (2, 2, 2),
     ("pod", "data", "model"), None),
    ((15, 2, 4, 16), (None, "kv_heads", None, None), (2, 4),
     ("data", "model"), "serve"),
    ((15, 4, 4, 16), (None, "kv_heads", None, None), (2, 4),
     ("data", "model"), "serve"),
    ((256, 512), ("embed", "heads"), (2, 4), ("data", "model"), "serve"),
    ((8, 8), None, (2, 4), ("data", "model"), None),
]
# every family beside dense (test_sharded_serve.py's overrides; the hybrid
# at 3 layers for a tail, the VLM at 4 layers in groups of 2)
FAMILIES = {
    "moe": dict(family="moe", first_k_dense=1, n_experts=4, top_k=2),
    "moe_shared": dict(family="moe", n_experts=4, top_k=2,
                       n_shared_experts=1),
    "ssm": dict(family="ssm", ssm_state=16, ssm_headdim=16, ssm_chunk=4),
    "hybrid": dict(family="hybrid", n_layers=3, ssm_state=16,
                   ssm_headdim=16, ssm_chunk=4, shared_attn_period=2),
    "encdec": dict(family="encdec", n_enc_layers=2, n_dec_layers=2),
    "vlm": dict(n_layers=4, cross_attn_group=2, n_cross_tokens=4),
}
# test_sharding_rules.py's serve caches: (name, {key: shape}, n_kv_heads)
RULE_CACHES = [
    ("paged", {"k_pages": (2, 15, 2, 4, 16), "v_pages": (2, 15, 2, 4, 16),
               "page_table": (4, 6), "pos": (4,)}, 2),
    ("dense", {"k": (2, 4, 2, 64, 16), "v": (2, 4, 2, 64, 16), "pos": (4,)},
     2),
    ("dense4", {"k": (2, 4, 4, 64, 16), "v": (2, 4, 4, 64, 16), "pos": (4,)},
     4),
]

JAX_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import jax, numpy as np
from repro.dist import serve as DSRV
from repro.dist import sharding as SH
from repro.launch.mesh import make_mesh
from repro.models import ModelConfig, get_model

case = json.loads(sys.argv[1])
spec = lambda p: [list(e) if isinstance(e, tuple) else e for e in p]
rules = {None: None, "serve": SH.SERVE_RULES}
out = {"rules": [], "rule_caches": {}, "meshes": {}}
for shape, axes, mshape, names, r in case["rule_cases"]:
    mesh = make_mesh(tuple(mshape), tuple(names))
    out["rules"].append(spec(SH.spec_for(
        tuple(shape), None if axes is None else tuple(axes), mesh, rules[r])))
base = case["base"]
mesh = make_mesh((2, 4), ("data", "model"))
for name, shapes, hkv in case["rule_caches"]:
    cfg = ModelConfig(**dict(base, n_kv_heads=hkv))
    cache = {k: np.zeros(v, np.float32) for k, v in shapes.items()}
    sh = DSRV.cache_shardings(cfg, cache, mesh)
    out["rule_caches"][name] = {k: spec(v.spec) for k, v in sh.items()}
cfg = ModelConfig(**base)
model = get_model(cfg)
params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), cfg)[0])
caches = {
    "dense": model.make_cache(cfg, 4, 24),
    "paged": model.make_paged_cache(cfg, 4, 24, page_size=4, pool_pages=14),
    "int8": model.make_paged_cache(cfg, 4, 24, page_size=4, pool_pages=14,
                                   page_dtype="int8")}
axes = model.axes(cfg)
out["axes"] = jax.tree.map(list, axes, is_leaf=lambda x: isinstance(x, tuple))
batch = {"tokens": np.zeros((4, 9), np.int32), "lens": np.zeros((4,), np.int32)}
out["batch_axes"] = jax.tree.map(list, SH.batch_axes_for(batch),
                                 is_leaf=lambda x: isinstance(x, tuple))
for mshape in case["meshes"]:
    mesh = make_mesh(tuple(mshape), ("data", "model"))
    got = {"params": jax.tree.map(
        lambda s: spec(s.spec),
        SH.tree_shardings(params, axes, mesh, SH.SERVE_RULES))}
    lanes = {"out": np.zeros((4, 6), np.int32), "tok": np.zeros((4,), np.int32)}
    got["lanes"] = jax.tree.map(lambda s: spec(s.spec),
                                DSRV.lane_shardings(lanes, mesh))
    for name, cache in caches.items():
        got[name] = {
            "axes": {k: list(v) for k, v in DSRV.cache_axes(cfg, cache).items()},
            "axes_for": {k: list(v) for k, v in SH.cache_axes_for(cache).items()},
            "specs": {k: spec(v.spec) for k, v in
                      DSRV.cache_shardings(cfg, cache, mesh).items()},
            "shapes": {k: list(v.shape) for k, v in cache.items()}}
    out["meshes"]["x".join(map(str, mshape))] = got
out["families"] = {}
mesh = make_mesh((2, 2), ("data", "model"))
for name, over in case["families"].items():
    cfg = ModelConfig(**dict(base, **over))
    model = get_model(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), cfg)[0])
    axes = model.axes(cfg)
    kw = {"src_len": 8} if cfg.family == "encdec" else {}
    caches = {"dense": model.make_cache(cfg, 4, 24, **kw)}
    if cfg.family != "ssm":
        caches["int8"] = model.make_paged_cache(
            cfg, 4, 24, page_size=4, pool_pages=14, page_dtype="int8", **kw)
    out["families"][name] = {
        "axes": jax.tree.map(list, axes,
                             is_leaf=lambda x: isinstance(x, tuple)),
        "params": jax.tree.map(
            lambda s: spec(s.spec),
            SH.tree_shardings(params, axes, mesh, SH.SERVE_RULES)),
        "caches": {c: {k: list(v) for k, v in
                       DSRV.cache_axes(cfg, cache).items()}
                   for c, cache in caches.items()}}
print("JSON" + json.dumps(out))
"""


def _listed(x):
    """A spec or axes tuple as JSON holds it (tuples as lists)."""
    if isinstance(x, dict):
        return {k: _listed(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return [_listed(e) for e in x]
    return x


def _mesh(shape, names=("data", "model"), coords=None):
    """A port mesh for resolving specs: no group is needed."""
    coords = coords or {a: 0 for a in names}
    return Mesh(tuple(names), dict(zip(names, shape)), dict(coords), {},
                "gloo", torch.device("cpu"), 0)


@pytest.fixture(scope="module")
def jax_out():
    case = {"rule_cases": RULE_CASES, "rule_caches": RULE_CACHES,
            "base": BASE, "meshes": MESHES, "families": FAMILIES}
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", "/root")}
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, json.dumps(case)],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stdout + r.stderr
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("JSON"))
    return json.loads(line[4:])


@pytest.mark.parametrize("i", range(len(RULE_CASES)))
def test_spec_for_matches_jax(jax_out, i):
    shape, axes, mshape, names, r = RULE_CASES[i]
    got = SH.spec_for(shape, axes, _mesh(mshape, names),
                      SH.SERVE_RULES if r == "serve" else None)
    assert _listed(got) == jax_out["rules"][i]


@pytest.mark.parametrize("name", [c[0] for c in RULE_CACHES])
def test_rule_caches_match_jax(jax_out, name):
    _, shapes, hkv = next(c for c in RULE_CACHES if c[0] == name)
    cfg = ModelConfig(**dict(BASE, n_kv_heads=hkv))
    cache = {k: torch.zeros(v) for k, v in shapes.items()}
    got = DS.cache_shardings(cfg, cache, _mesh((2, 4)))
    assert _listed(got) == jax_out["rule_caches"][name]


def test_dense_axes_tree_matches_jax(jax_out):
    cfg = ModelConfig(**BASE)
    assert _listed(get_model(cfg).axes(cfg)) == jax_out["axes"]
    batch = {"tokens": torch.zeros(4, 9), "lens": torch.zeros(4)}
    assert _listed(SH.batch_axes_for(batch)) == jax_out["batch_axes"]


@pytest.mark.parametrize("mshape", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_param_and_cache_specs_match_jax(jax_out, mshape):
    """Every parameter's spec (the port's per-layer tensors against JAX's
    stacked ones, whose layer dim is never cut) and every cache key's axes
    and spec."""
    cfg = ModelConfig(**BASE)
    fam = get_model(cfg)
    mesh = _mesh(mshape)
    want = jax_out["meshes"]["x".join(map(str, mshape))]
    model = fam.init(cfg, torch.Generator().manual_seed(0), "cpu")
    axes = DS.param_axes(model, cfg)
    for name, p in model.named_parameters():
        node, n = want["params"], 0
        for part in name.split("."):
            if part.isdigit():
                n += 1
            else:
                node = node[part]
        assert node[:n] == [None] * n, (name, node)
        got = SH.spec_for(p.shape, axes[name], mesh, SH.SERVE_RULES)
        assert _listed(got) == node[n:], (name, got, node)
    caches = {"dense": fam.make_cache(cfg, 4, 24, device="cpu"),
              "paged": fam.make_paged_cache(cfg, 4, 24, page_size=4,
                                            pool_pages=14, device="cpu"),
              "int8": fam.make_paged_cache(cfg, 4, 24, page_size=4,
                                           pool_pages=14, page_dtype="int8",
                                           device="cpu")}
    lanes = {"out": torch.zeros(4, 6), "tok": torch.zeros(4)}
    assert _listed(DS.lane_shardings(lanes, mesh)) == want["lanes"]
    for cname, cache in caches.items():
        w = want[cname]
        assert {k: list(v.shape) for k, v in cache.items()} == w["shapes"]
        assert _listed(DS.cache_axes(cfg, cache)) == w["axes"], cname
        assert _listed(SH.cache_axes_for(cache)) == w["axes_for"], cname
        assert DS.constrain_cache(cfg, cache) is cache
        assert _listed(DS.cache_shardings(cfg, cache, mesh)) == w["specs"], \
            cname


@pytest.mark.parametrize("m", (1, 2))
def test_local_blocks_are_the_local_caches_and_whole_heads(m):
    """At each coordinate of a (1, m) mesh: every cache key's block under
    its spec has the shape of the cache ``local_config`` allocates, and
    ``shard_params`` leaves each rank whole heads, its columns of the MLP
    and its vocab rows, and wo and w_down whole."""
    cfg = ModelConfig(**BASE)
    fam = get_model(cfg)
    full = {"dense": fam.make_cache(cfg, 4, 24, device="cpu"),
            "int8": fam.make_paged_cache(cfg, 4, 24, page_size=4,
                                         pool_pages=14, page_dtype="int8",
                                         device="cpu")}
    whole = fam.init(cfg, torch.Generator().manual_seed(0), "cpu")
    for r in range(m):
        mesh = _mesh((1, m), coords={"data": 0, "model": r})
        local = DS.local_config(cfg, mesh)
        mine = {"dense": fam.make_cache(local, 4, 24, device="cpu"),
                "int8": fam.make_paged_cache(local, 4, 24, page_size=4,
                                             pool_pages=14, page_dtype="int8",
                                             device="cpu")}
        for cname, cache in full.items():
            specs = DS.cache_shardings(cfg, cache, mesh)
            for k, v in cache.items():
                assert (SH.local_slice(v, specs[k], mesh).shape
                        == mine[cname][k].shape), (cname, k)
        model = DS.shard_params(
            fam.init(cfg, torch.Generator().manual_seed(0), "cpu"), cfg, mesh)
        hd = cfg.resolved_head_dim
        a, b = model.blocks[1].attn, whole.blocks[1].attn
        q_cols = slice(r * cfg.n_heads // m * hd, (r + 1) * cfg.n_heads // m * hd)
        kv_cols = slice(r * cfg.n_kv_heads // m * hd,
                        (r + 1) * cfg.n_kv_heads // m * hd)
        assert torch.equal(a.wq, b.wq[:, q_cols])
        assert torch.equal(a.wk, b.wk[:, kv_cols])
        assert torch.equal(a.wv, b.wv[:, kv_cols])
        assert torch.equal(a.wo, b.wo)
        f = cfg.d_ff // m
        mm, wm = model.blocks[1].mlp, whole.blocks[1].mlp
        assert torch.equal(mm.w_up, wm.w_up[:, r * f:(r + 1) * f])
        assert torch.equal(mm.w_gate, wm.w_gate[:, r * f:(r + 1) * f])
        assert torch.equal(mm.w_down, wm.w_down)
        v = cfg.padded_vocab // m
        assert torch.equal(model.embed.tok, whole.embed.tok[r * v:(r + 1) * v])
        assert torch.equal(model.embed.unembed,
                           whole.embed.unembed[:, r * v:(r + 1) * v])
        # cut once: a second engine on the same model leaves it as it is
        assert DS.shard_params(model, cfg, mesh) is model
        assert torch.equal(model.embed.tok, whole.embed.tok[r * v:(r + 1) * v])


@pytest.mark.parametrize("over,shape,what", [
    ({}, {"data": 1, "model": 4}, "kv_seq flash-decode fallback"),
    (dict(family="moe", n_experts=4, top_k=2, moe_groups=2),
     {"data": 2, "model": 1}, "moe_groups=2"),
])
def test_uncovered_meshes_name_item_14(over, shape, what):
    """What mesh serving leaves out is refused naming its item; every
    family (the VLM branch too) is served on a data 2 x model 2 mesh, and
    an ssm model, which cuts no heads, on any model axis."""
    cfg = ModelConfig(**dict(BASE, **over))
    with pytest.raises(NotImplementedError, match="Queue 1 item 14") as e:
        DS.check_mesh(cfg, shape)
    assert what in str(e.value)
    for fam in ("dense", "ssm", "moe", "hybrid", "encdec"):
        DS.check_mesh(ModelConfig(**dict(BASE, family=fam)),
                      {"data": 2, "model": 2})
    DS.check_mesh(ModelConfig(**dict(BASE, cross_attn_group=2)),
                  {"data": 2, "model": 2})
    ssm = ModelConfig(**dict(BASE, family="ssm", n_heads=1, n_kv_heads=1))
    DS.check_mesh(ssm, {"data": 4, "model": 4})
    mesh = _mesh((4, 4))
    assert DS.local_config(ssm, mesh) is ssm
    assert DS.local_lanes(8, mesh) == 2 and DS.local_lanes(6, mesh) == 6


def _param_specs_match(model, cfg, mesh, want):
    """Every parameter's axes (``param_axes``) and spec on ``mesh`` against
    JAX's stacked tree, whose layer dims are never cut."""
    axes = DS.param_axes(model, cfg)
    for name, p in model.named_parameters():
        node, n = want, 0
        for part in name.split("."):
            if part.isdigit():
                n += 1
            else:
                node = node[part]
        assert node[:n] == [None] * n, (name, node)
        got = SH.spec_for(p.shape, axes[name], mesh, SH.SERVE_RULES)
        assert _listed(got) == node[n:], (name, got, node)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_axes_params_and_caches_match_jax(jax_out, name):
    """Each family's axes tree, every parameter's spec on a data 2 x model 2
    mesh and every cache key's axes (dense and int8-paged) against JAX's;
    then ``shard_params`` at model coordinate 1 leaves each parameter its
    block (experts, heads, MLP columns, vocab; Mamba2 blocks whole) and the
    caches ``local_config`` allocates are the blocks of the whole ones."""
    cfg = ModelConfig(**dict(BASE, **FAMILIES[name]))
    fam = get_model(cfg)
    want = jax_out["families"][name]
    assert _listed(fam.axes(cfg)) == want["axes"]
    model = fam.init(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = _mesh((2, 2), coords={"data": 1, "model": 1})
    _param_specs_match(model, cfg, mesh, want["params"])
    kw = {"src_len": 8} if cfg.family == "encdec" else {}
    caches = {"dense": fam.make_cache(cfg, 4, 24, device="cpu", **kw)}
    if cfg.family != "ssm":
        caches["int8"] = fam.make_paged_cache(
            cfg, 4, 24, page_size=4, pool_pages=14, page_dtype="int8",
            device="cpu", **kw)
    local = DS.local_config(cfg, mesh)
    for cname, cache in caches.items():
        assert _listed(DS.cache_axes(cfg, cache)) == want["caches"][cname]
        specs = DS.cache_shardings(cfg, cache, mesh)
        mine = (fam.make_cache(local, 2, 24, device="cpu", **kw)
                if cname == "dense" else fam.make_paged_cache(
                    local, 2, 24, page_size=4, pool_pages=14,
                    page_dtype="int8", device="cpu", **kw))
        for k, v in cache.items():
            assert SH.local_slice(v, specs[k], mesh).shape == mine[k].shape, \
                (cname, k)
    whole = dict(fam.init(cfg, torch.Generator().manual_seed(0),
                          "cpu").named_parameters())
    axes = DS.param_axes(model, cfg)
    DS.shard_params(model, cfg, mesh)
    for pname, p in model.named_parameters():
        spec = SH.spec_for(whole[pname].shape, axes[pname], mesh,
                           SH.SERVE_RULES)
        assert torch.equal(p, SH.local_slice(whole[pname], spec, mesh)), pname
