"""Mesh-agnostic sharding resolution, the port's copy of the JAX package's
``dist/sharding.py`` (DESIGN.md §2).

Model code names every array dim with a LOGICAL axis ("embed", "heads",
"batch", ...) and never a mesh.  The rule table below resolves each
logical name onto the mesh axes that exist, with the discipline SVE applies
to vector lanes:

  * **divisibility fallback** — a dim that doesn't divide the mesh axis size
    replicates instead of erroring (the VL-agnostic "partial last strip").
  * **no axis reuse** — one mesh axis shards at most one dim per array,
    resolved left to right.
  * **folding** — "batch" folds all pure-DP axes present ("pod" x "data").
  * **flash-decode fallback** — when kv_heads can't take the "model" axis
    (GQA with few KV heads), the kv_seq dim takes it instead, which is
    exactly the flash-decode split-K layout.

A resolved spec is a tuple with one entry per dim: a mesh-axis name, a
tuple of names (folded axes), or None (whole) — what a JAX
``PartitionSpec`` holds, without JAX.  ``mesh`` is a
``launch.mesh.Mesh`` (anything with ``axis_names`` and ``shape[axis]``).

There is no GSPMD here: the port places and gathers by hand.  Each rank
holds its block of every sharded tensor (``local_slice``), and where JAX
asks the compiler for a layout with a sharding constraint, the port's
layer seams call ``constrain``, which all-gathers the blocks when the
active rules want the dim whole.  ``use_mesh_rules`` makes the mesh and
the rules active for the seams.

Training (``DEFAULT_RULES``) adds what GSPMD would insert for a sharded
train step: Megatron's conjugate pair as ``torch.autograd.Function``s,
``to_model`` (f: the identity forward, a psum over "model" backward, on
the input of every column-parallel product) and ``from_model`` (g: a psum
over "model" forward, the identity backward, on the output of every
row-parallel product); while a rank trains on its block of the lanes
(``batch_cut``), the sums of the loss's and the aux losses' partial sums
over "batch" (``batch_sum``, a g over "batch"); and, around the step's
autograd, the FSDP gather of the weights' "data" blocks and the
reduce-scatter of their gradients (``fsdp_gather``, ``fsdp_reduce``: one
flat collective per dtype).  Every sum runs over the ranks in a fixed
order.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import BATCH_AXES, batch_shard_count

from . import collectives as C

# logical axis -> ordered tuple of mesh axes it may occupy (folded jointly
# when more than one is present).  Missing mesh axes are simply skipped.
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "act_seq": ("model",),          # Megatron-SP residual split
    "act_heads": ("model",),
    "act_kv_heads": ("model",),
    "act_experts": ("model",),      # MoE dispatch/combine expert dim
    "act_mlp": ("model",),          # MLP intermediate stays sharded between
                                    # up-proj and down-proj (Megatron TP pair)
    "act_vocab": ("model",),        # logits leave the unembed dot vocab-
                                    # sharded; sampling gathers the (tiny)
                                    # logit row, never the head weight
    "kv_seq": ("model",),           # flash-decode fallback target
    "embed": ("data",),             # FSDP-ish weight split
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    # contraction-feeding weight dims (attention wo, MLP w_down) and the
    # out-proj input: Megatron row-parallel in training — a partial dot per
    # shard, psum after.  Serving overrides these (see SERVE_RULES).
    "heads_in": ("model",),
    "mlp_in": ("model",),
    "act_attn_in": ("model",),
    "act_mlp_in": ("model",),
    "act_experts_in": ("model",),   # MoE dispatch-gather output
    "act_experts_out": ("model",),  # MoE expert outputs entering combine
    "vocab": ("model",),
    "experts": ("model",),
    "layers": (),                   # scanned axis: never sharded
}

# Serving variant: decode reads every weight every step, so an FSDP-style
# "embed" split over the data axis would all-gather the full parameter set
# per layer per token — during serving the data axis carries request LANES
# only.  act_seq likewise stays whole (decode sequence length is 1; prefill
# chunks are short and batch-sharded already).
#
# heads_in / mlp_in / act_attn_in / act_mlp_in replicate: served tokens must
# be BYTE-identical to the 1-device engine, and a Megatron row-parallel dot
# (split contraction + psum) reassociates the f32 sum — ulp-level logit
# noise that top-p's sort order then amplifies into a different sampled
# token.  Serving therefore keeps only COLUMN-parallel weights sharded
# (qkv / mlp-up / unembed: contraction dim whole, bitwise per element),
# replicates the row-parallel weights, and all-gathers the small
# activations (merged attn heads, MLP intermediate) right before their
# dots — every contraction runs whole, so logits are bitwise-identical to
# the unsharded engine BY CONSTRUCTION, and the per-step collectives are a
# few KB of activations instead of per-layer reductions.  act_mlp itself
# stays SHARDED so the up/gate dot outputs land sharded; only the
# act_mlp_in seam before the down-proj gathers.
SERVE_RULES = dict(DEFAULT_RULES, embed=(), act_seq=(),
                   heads_in=(), mlp_in=(), act_attn_in=(), act_mlp_in=(),
                   act_experts_in=(), act_experts_out=())


def _candidates(name: str, mesh, rules) -> list[tuple[str, ...]]:
    """Orderings to try for one logical name: the full folded tuple of
    present mesh axes first, then each single axis."""
    want = rules.get(name, ())
    present = tuple(a for a in want if a in mesh.axis_names)
    if not present:
        return []
    cands = [present]
    if len(present) > 1:
        cands += [(a,) for a in present]
    return cands


def spec_for(shape, axes, mesh, rules: Optional[dict] = None) -> tuple:
    """Resolve one array's logical axes tuple to a spec on ``mesh``.

    ``axes``: tuple of logical names (or None) matching ``shape``'s rank, or
    None for a fully replicated array (the empty spec).
    """
    if axes is None:
        return ()
    rules = DEFAULT_RULES if rules is None else rules
    used: set[str] = set()
    entries = []
    for dim, name in zip(shape, axes):
        placed = None
        if name is not None:
            for cand in _candidates(name, mesh, rules):
                free = tuple(a for a in cand if a not in used)
                if len(free) != len(cand):
                    continue                      # no mesh-axis reuse
                size = 1
                for a in free:
                    size *= mesh.shape[a]
                if size > 1 and dim % size == 0:  # divisibility fallback
                    placed = free
                    break
            if placed is not None:
                used.update(placed)
        entries.append(placed[0] if placed is not None and len(placed) == 1
                       else placed)
    return tuple(entries)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (and of the matching dicts
    ``rest``), keeping the structure: the port's ``jax.tree.map`` for the
    dicts of tensors and of axes tuples used here."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_shardings(tree, axes_tree, mesh, rules: Optional[dict] = None):
    """The spec of every leaf of ``tree`` (nested dicts of anything with a
    ``shape``) given the matching tree of logical-axes tuples (tuples are
    leaves of ``axes_tree``)."""
    if isinstance(axes_tree, dict):
        return {k: tree_shardings(tree[k], v, mesh, rules)
                for k, v in axes_tree.items()}
    return spec_for(tree.shape, axes_tree, mesh, rules)


def batch_axes_for(batch):
    """Logical axes for an input batch dict: leading dim is the request/lane
    axis, everything else replicated."""
    return tree_map(lambda leaf: ("batch",) + (None,) * (len(leaf.shape) - 1),
                    batch)


def cache_axes_for(cache):
    """Logical axes for a decode-cache dict (see models.cache_batch_axes for
    the authoritative per-family lane axis; this mirrors those layouts)."""
    out = {}
    for key, leaf in cache.items():
        nd = len(leaf.shape)
        if nd == 1:
            out[key] = ("batch",)
        elif "conv" in key:                        # (..., B, W, D)
            ax = [None] * nd
            ax[nd - 3] = "batch"
            out[key] = tuple(ax)
        elif "state" in key:                       # (..., B, H, hd, state)
            ax = [None] * nd
            ax[nd - 4] = "batch"
            out[key] = tuple(ax)
        else:                                      # KV: (..., B, Hkv, S, D)
            ax = [None] * nd
            ax[nd - 4] = "batch"
            ax[nd - 3] = "act_kv_heads"
            ax[nd - 2] = "kv_seq"
            out[key] = tuple(ax)
    return out


def block_of(entry, mesh) -> tuple[int, int]:
    """(this rank's block index, number of blocks) of a dim resolved to
    ``entry`` (an axis name, a tuple of names folded row-major, or None)."""
    names = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    idx, n = 0, 1
    for a in names:
        idx = idx * mesh.shape[a] + mesh.coords[a]
        n *= mesh.shape[a]
    return idx, n


def local_slice(t, spec, mesh):
    """This rank's block of ``t`` (a tensor) under ``spec``: a view of
    ``t``."""
    for dim, entry in enumerate(spec):
        idx, n = block_of(entry, mesh)
        if n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, idx * size, size)
    return t


# ---------------------------------------------------------------------------
# The active mesh of the layer seams (opt-in, none otherwise)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[tuple] = None


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: Optional[dict] = None):
    """Within this context the layer seams (``constrain``, ``gather``) place
    against ``mesh`` under ``rules``; outside it there is no mesh."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, (mesh, DEFAULT_RULES if rules is None else rules)
    try:
        yield
    finally:
        _ACTIVE = prev


def rules_active() -> bool:
    """True inside a ``use_mesh_rules`` context."""
    return _ACTIVE is not None


def active_mesh():
    """The mesh of the enclosing ``use_mesh_rules``; raises outside one (a
    tensor cut into blocks reached a seam with no mesh to gather over)."""
    if _ACTIVE is None:
        raise RuntimeError("a sharded tensor outside use_mesh_rules: no mesh "
                           "to gather its blocks over")
    return _ACTIVE[0]


class _Gather(torch.autograd.Function):
    """All-gather forward; backward, this rank's block of the gradient (the
    consumer of the whole tensor runs replicated over the group, so each
    rank's gradient of it is the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.idx = dist.get_rank(group)
        return C.all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.idx * ctx.size, ctx.size), None, None


def gather(x, dim: int, axis: str = "model"):
    """All-gather the blocks of ``x``'s dim ``dim`` over the active mesh's
    ``axis`` ("batch": the folded pod x data line), concatenated in
    coordinate order: the whole dim on every rank.  Under autograd its
    backward hands each rank its block of the gradient."""
    group = active_mesh().groups[axis]
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, group, dim)
    return C.all_gather(x, group, dim)


# ---------------------------------------------------------------------------
# Request lanes over the batch axes (pod x data)
# ---------------------------------------------------------------------------

def lane_block(b: int, mesh) -> tuple[int, int]:
    """(first lane, lane count) of this rank's block of ``b`` request lanes:
    cut into ``batch_shard_count`` blocks in rank order over the folded batch axes
    when that divides ``b``, else replicated (every rank holds all ``b``:
    the divisibility fallback).  Lanes are cut over all the batch axes or
    none, so one gather over the "batch" group makes them whole."""
    n = batch_shard_count(mesh)
    if n == 1 or b % n:
        return 0, b
    names = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
    return block_of(names, mesh)[0] * (b // n), b // n


def lane_mesh():
    """The active mesh when its batch axes cut lanes (``batch_shard_count``
    > 1), else None: the lane movers ask it."""
    if _ACTIVE is None or batch_shard_count(_ACTIVE[0]) == 1:
        return None
    return _ACTIVE[0]


_LANES_CUT = False


@contextlib.contextmanager
def lanes_cut():
    """Within this context the model runs on this rank's block of the
    call's lanes (the engine's model seam): a seam that needs every lane —
    the K/V store into a page pool every batch rank holds whole, the MoE
    dispatch over all the call's tokens — gathers over "batch"."""
    global _LANES_CUT
    prev, _LANES_CUT = _LANES_CUT, True
    try:
        yield
    finally:
        _LANES_CUT = prev


def lanes_are_cut() -> bool:
    """True inside ``lanes_cut``."""
    return _LANES_CUT


def constrain(x, dim: int, name: str):
    """``x`` holds, along ``dim``, this rank's block of a dim cut over the
    model axis (a column-parallel product's output).  Lay it out as the
    active rules place the logical axis ``name``: where it resolves to no
    mesh axis (serving's ``act_attn_in`` and ``act_mlp_in``), gather the
    blocks so the next contraction runs whole.  Where it rides the model
    axis (training's row-parallel layout) ``x`` stays cut: the product it
    feeds is a partial one, and ``from_model`` sums it."""
    mesh, rules = active_mesh(), _ACTIVE[1]
    if any(a in mesh.axis_names for a in rules.get(name, ())):
        return x
    return gather(x, dim)


# ---------------------------------------------------------------------------
# Training: Megatron's f and g, the FSDP gather, the sums over the lanes
# ---------------------------------------------------------------------------

class _ToModel(torch.autograd.Function):
    """Megatron's f: the identity forward, a psum over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return C.ordered_psum(g, ctx.group), None


class _SumForward(torch.autograd.Function):
    """Megatron's g: ``psum(x, group)`` (a sum over the group) forward, the
    identity backward: each rank's part enters the whole sum, and its
    gradient is the sum's."""

    @staticmethod
    def forward(ctx, x, group, psum):
        return psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _model_group():
    """The active mesh's "model" group, or None where no model axis cuts."""
    if _ACTIVE is None:
        return None
    mesh = _ACTIVE[0]
    if mesh.shape.get("model", 1) == 1:
        return None
    return mesh.groups["model"]


def to_model(x):
    """Megatron's f on the input ``x`` of a column-parallel product (a
    weight cut over "model"): ``x`` itself forward; backward, the psum over
    "model" of every rank's partial gradient.  The identity outside
    autograd or without a model axis."""
    group = _model_group()
    if group is None or not torch.is_grad_enabled():
        return x
    return _ToModel.apply(x, group)


def from_model(x):
    """Megatron's g on the output ``x`` of a row-parallel product (a
    contraction cut over "model"): the psum over "model" of every rank's
    partial product, in rank order; backward, the identity."""
    group = _model_group()
    if group is None:
        return x
    if not torch.is_grad_enabled():
        return C.ordered_psum(x, group)
    return _SumForward.apply(x, group, C.ordered_psum)


def _data_dim(spec):
    """The dim of a weight that ``spec`` cuts over "data" (None: none)."""
    return next((i for i, e in enumerate(spec) if e == "data"), None)


def _by_dtype(tensors: dict) -> dict:
    """Names grouped by their tensors' dtype, each group in dict order (one
    collective a group)."""
    groups: dict = {}
    for name, t in tensors.items():
        groups.setdefault(t.dtype, []).append(name)
    return groups


def fsdp_gather(blocks: dict, specs: dict, mesh) -> dict:
    """Each rank's blocks of the weights (a dict by name, ``specs`` their
    specs) gathered whole over "data": the blocks the model axis leaves
    this rank, which a step's forward reads.  The weights cut over "data"
    travel as one flat all-gather per dtype; the others are returned as
    they are."""
    out = dict(blocks)
    if mesh.shape.get("data", 1) == 1:
        return out
    group = mesh.groups["data"]
    cut = {n: t for n, t in blocks.items() if _data_dim(specs[n]) is not None}
    for names in _by_dtype(cut).values():
        flat = torch.cat([cut[n].reshape(-1) for n in names])
        rows = C.all_gather(flat.unsqueeze(0), group, 0)
        off = 0
        for n in names:
            t = cut[n]
            parts = [r[off:off + t.numel()].view(t.shape) for r in rows]
            out[n] = torch.cat(parts, dim=_data_dim(specs[n]))
            off += t.numel()
    return out


def fsdp_reduce(grads: dict, specs: dict, mesh, *, summed: bool) -> dict:
    """The gradients of the gathered weights (by name) back to this rank's
    blocks: where each data rank trained on its own lanes (``summed``),
    summed over "data" in rank order (a weight cut over "data" by one flat
    reduce-scatter per dtype, summed in f32; the others by one psum per
    dtype), else only cut (every data rank's gradient is the whole
    batch's)."""
    d = mesh.shape.get("data", 1)
    if d == 1:
        return dict(grads)
    group, idx = mesh.groups["data"], mesh.coords["data"]
    out = {}
    whole = {n: g for n, g in grads.items() if _data_dim(specs[n]) is None}
    cut = {n: g for n, g in grads.items() if n not in whole}
    for names in _by_dtype(cut).values():
        parts = [cut[n].chunk(d, _data_dim(specs[n])) for n in names]
        if summed:
            rows = torch.stack([torch.cat([p[r].reshape(-1) for p in parts])
                                for r in range(d)])
            mine = C.reduce_scatter(rows, group, 0)[0]
        else:
            mine = torch.cat([p[idx].reshape(-1) for p in parts])
        off = 0
        for n, p in zip(names, parts):
            out[n] = mine[off:off + p[idx].numel()].view(p[idx].shape)
            off += p[idx].numel()
    for names in _by_dtype(whole).values():
        if not summed:
            out.update({n: whole[n] for n in names})
            continue
        flat = C.ordered_psum(torch.cat([whole[n].reshape(-1)
                                         for n in names]), group)
        off = 0
        for n in names:
            out[n] = flat[off:off + whole[n].numel()].view(whole[n].shape)
            off += whole[n].numel()
    return {n: out[n] for n in grads}


_BATCH_CUT = False


@contextlib.contextmanager
def batch_cut():
    """Within this context a training rank runs on its block of the
    batch's lanes: the loss and the MoE aux losses sum their partial sums
    over "batch" (``batch_sum``), and the MoE dispatch groups are the
    rank's own."""
    global _BATCH_CUT
    prev, _BATCH_CUT = _BATCH_CUT, True
    try:
        yield
    finally:
        _BATCH_CUT = prev


def batch_blocks() -> int:
    """How many blocks the lanes are cut into inside ``batch_cut`` (1
    outside it)."""
    return batch_shard_count(active_mesh()) if _BATCH_CUT else 1


def batch_sum(x):
    """The sum of ``x`` (a partial sum over this rank's lanes) over the
    lanes of every rank, inside ``batch_cut``; ``x`` itself outside it.
    Its gradient is this rank's share (the data ranks' gradients are summed
    by ``fsdp_reduce``)."""
    if batch_blocks() == 1:
        return x
    group = active_mesh().groups["batch"]
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumForward.apply(x, group, C.sum_scalars)
    return C.sum_scalars(x, group)


def counted(spec, mesh) -> bool:
    """Whether this rank's block of a tensor of ``spec`` counts in a sum
    over the whole mesh (a global norm): a block replicated over an axis
    counts once, on that axis's coordinate 0."""
    used = set()
    for e in spec:
        used.update(() if e is None else ((e,) if isinstance(e, str) else e))
    return all(mesh.coords[a] == 0 for a in mesh.axis_names if a not in used)


def gather_whole(t, spec, mesh):
    """The whole tensor of which ``t`` is this rank's block under ``spec``:
    every cut dim all-gathered over its axes (a collective: every rank
    calls it)."""
    for dim, entry in enumerate(spec):
        if entry is None or block_of(entry, mesh)[1] == 1:
            continue
        axis = entry if isinstance(entry, str) else "batch"
        t = C.all_gather(t, mesh.groups[axis], dim)
    return t
