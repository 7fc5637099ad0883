"""Serve-state placement: resolve the engine's weights and the scheduler's
device state onto a process mesh, the port's counterpart of the JAX
package's ``dist/serve.py``.

ONE serve program whose state placement — KV page pools over the
``model`` axis's KV-head shards, request lanes over the ``data`` axis —
resolves through the same logical-axis rule table
(``dist.sharding.spec_for``) on whatever mesh exists.  Model code names no
mesh; where JAX commits arrays to a sharding and lets GSPMD propagate it,
each rank here holds its own block: ``shard_params`` cuts the weights, the
engine allocates caches at this rank's head counts (``local_config``) and
lanes (``local_lanes``), and the seams gather what the next step needs
whole.

Layout contract (all via ``SERVE_RULES`` — no FSDP weight split while
serving, the data axis carries lanes only):

  * page pools ``<key>_pages`` — ``lead + (P, Hkv, page_size, D)``: KV
    heads take "model" ("kv_heads" rule).  The page and page-size dims are
    never sharded — pages are gathered by table, splitting them would turn
    every gather into a collective — so every data rank holds the whole
    pool at its KV heads, and every rank stores every lane's new K/V (the
    rows are gathered over "batch" before the store).
  * scale pools ``<key>_pages_scale`` — ``lead + (P, Hkv, page_size)``
    (quantized caches): KV heads take "model" with their pool.
  * per-lane dense KV — ``lead + (B, Hkv, S, D)``, the encdec and VLM cross
    K/V among them: lanes over "data", KV heads over "model" (the
    ``kv_seq`` flash-decode fallback for head counts the axis does not
    divide is not ported: ``check_mesh``).
  * conv taps ``(..., B, W-1, C)`` and SSM states ``(..., B, H, P, N)``:
    lanes over "data", the rest whole (no rule cuts "ssm_inner": a Mamba2
    block is whole on every model rank).
  * page tables / per-lane scalars / sampler lanes / out_buf: lanes over
    "data" in the logical spec.  The engine keeps the page tables, ``pos``
    and its decode carry whole on every rank (``models.WHOLE_KEYS``): they
    are a few bytes a lane, index the replicated pools, and every host
    decision reads them.

A dim the axis does not divide is replicated (the divisibility fallback):
lanes a batch axis does not divide are held whole by every rank, experts
the model axis does not divide likewise.

What this covers: every family (dense and its VLM branch, moe, ssm,
hybrid, encdec) on any ``data x model`` mesh (a "pod" axis folds into
"batch") whose model axis cuts the heads and KV heads into whole heads.
Weights: heads, KV heads, MLP up/gate columns, experts and vocab over
"model"; ``wo``, ``w_down`` and the Mamba2 blocks whole.  Not covered
(``check_mesh``, ROADMAP Queue 1 item 14): the ``kv_seq`` fallback and
``moe_groups`` > 1.
"""

from __future__ import annotations

from typing import Optional

from repro_torch import models as M

from . import sharding as SH

#: per-lane KV arrays end in (B, Hkv, S, D): rank past the lane axis
_KV_TAIL_RANK = 4
_ITEM = "ROADMAP Queue 1 item 14"


def check_mesh(cfg, shape: dict) -> None:
    """Refuse, naming the ROADMAP item that ports it, a mesh (``shape``:
    axis name -> size) that mesh serving of ``cfg`` does not cover: a model
    axis that does not cut the heads and the KV heads into whole-head
    blocks (the ``kv_seq`` flash-decode fallback; an ssm model cuts no
    heads, only its vocab), and moe dispatch groups (``moe_groups`` > 1).
    Any batch axes are served: lanes are cut over them, or replicated where
    they do not divide."""
    unknown = set(shape) - {"pod", "data", "model"}
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}")
    if cfg.family == "moe" and cfg.moe_groups != 1:
        raise NotImplementedError(
            f"moe_groups={cfg.moe_groups} splits the dispatch over the data "
            f"shards, which is not ported yet ({_ITEM})")
    m = shape.get("model", 1)
    if cfg.family != "ssm" and (cfg.n_heads % m or cfg.n_kv_heads % m):
        raise NotImplementedError(
            f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads do not cut "
            f"into {m} whole-head blocks: the kv_seq flash-decode fallback is "
            f"not ported yet ({_ITEM})")


def local_config(cfg, mesh):
    """``cfg`` at this rank's head counts (and the head dim pinned): the
    config its caches are allocated from.  An ssm model cuts no heads.
    ``local_lanes`` gives the rank's lane count."""
    if cfg.family == "ssm":
        return cfg
    m = mesh.shape.get("model", 1)
    return cfg.replace(n_heads=cfg.n_heads // m, n_kv_heads=cfg.n_kv_heads // m,
                       head_dim=cfg.resolved_head_dim)


def local_lanes(b: int, mesh) -> int:
    """How many of ``b`` request lanes this rank holds: ``b`` over the batch
    axes (pod x data) when they divide it, else all ``b`` (replicated)."""
    return SH.lane_block(b, mesh)[1]


def cache_axes(cfg, cache) -> dict:
    """Logical-axes tuples for every key of a serve cache (dense or paged).

    Derives the lane axis from the family's ``cache_batch_axes`` contract
    and the KV-vs-state split from key names — the serve-side mirror of
    ``models`` layouts, kept here so model code never sees a mesh.
    """
    lane_ax = M.get_model(cfg).cache_batch_axes(cfg)
    out = {}
    for key, leaf in cache.items():
        nd = len(leaf.shape)
        if key == "page_table":
            out[key] = ("batch",) + (None,) * (nd - 1)
        elif key.endswith("_pages"):
            ax = [None] * nd
            ax[nd - 3] = "kv_heads"
            out[key] = tuple(ax)
        elif key.endswith("_pages_scale"):
            # per-slot scale pools lead + (P, Hkv, ps): shard the head axis
            # with the pool it scales; page dims stay whole
            ax = [None] * nd
            ax[nd - 2] = "kv_heads"
            out[key] = tuple(ax)
        elif key in lane_ax:
            la = lane_ax[key]
            ax = [None] * nd
            ax[la] = "batch"
            if (nd - la == _KV_TAIL_RANK and "conv" not in key
                    and "state" not in key):
                ax[la + 1] = "act_kv_heads"
                ax[la + 2] = "kv_seq"
            out[key] = tuple(ax)
        else:
            out[key] = (None,) * nd
    return out


def cache_shardings(cfg, cache, mesh, rules: Optional[dict] = None) -> dict:
    """The spec of every key of ``cache`` (a full-size cache or anything
    with its shapes): ``local_slice`` of a key under its spec is this
    rank's block, the shape ``local_config``'s caches have."""
    rules = SH.SERVE_RULES if rules is None else rules
    return SH.tree_shardings(cache, cache_axes(cfg, cache), mesh, rules)


def lane_shardings(tree, mesh, rules: Optional[dict] = None):
    """Specs for any dict of lane-leading tensors (out_buf, tok, sampler
    state, ...): "batch" on dim 0, rest replicated."""
    rules = SH.SERVE_RULES if rules is None else rules
    return SH.tree_map(
        lambda leaf: SH.spec_for(
            leaf.shape, ("batch",) + (None,) * (len(leaf.shape) - 1), mesh,
            rules),
        tree)


def param_axes(model, cfg) -> dict:
    """Parameter name -> logical axes, from the family's axes tree (the
    JAX package's, stacked layers first).  A module-list index in the name
    is a stacked layer axis of the tree (as ``models.convert`` maps them),
    so it drops one leading "layers" from the axes."""
    tree = M.get_model(cfg).axes(cfg)
    out = {}
    for name, _ in model.named_parameters():
        node, drop = tree, 0
        for part in name.split("."):
            if part.isdigit():
                drop += 1
            else:
                node = node[part]
        if tuple(node[:drop]) != ("layers",) * drop:
            raise ValueError(f"{name}: axes {node} do not stack {drop} layers")
        out[name] = tuple(node[drop:])
    return out


def shard_params(model, cfg, mesh, rules: Optional[dict] = None):
    """Cut every parameter of ``model`` to this rank's block, IN PLACE, by
    the family's logical axes under ``rules`` (``SERVE_RULES``: heads, KV
    heads, the MLP's up/gate columns, experts and the vocab over "model";
    wo, w_down and the Mamba2 blocks whole).  Returns the model.  A model already cut for this mesh
    is left as it is; one cut for another mesh raises."""
    check_mesh(cfg, mesh.shape)
    rules = SH.SERVE_RULES if rules is None else rules
    key = (tuple(mesh.shape.items()), tuple(mesh.coords.items()))
    done = getattr(model, "shard_key", None)
    if done == key:
        return model
    if done is not None:
        raise ValueError(f"the model is cut for mesh {done}, not {key}")
    axes = param_axes(model, cfg)
    for name, p in model.named_parameters():
        spec = SH.spec_for(p.shape, axes[name], mesh, rules)
        if any(e is not None for e in spec):
            # a copy: the whole tensor's storage is freed with it
            p.data = SH.local_slice(p.data, spec, mesh).clone()
    model.shard_key = key
    return model


def constrain_cache(cfg, cache) -> dict:
    """The identity.  JAX constrains a cache built inside a jitted trace so
    GSPMD does not materialise it replicated; here every cache, the fused
    step's admission sub-caches included, is allocated at this rank's head
    counts (``local_config``) and is this rank's block already."""
    return cache
