"""Deterministic cross-device reductions — the paper's horizontal-operation
orderings (§2.3.6) at chip scale — on ``torch.distributed``, the port's
copy of the JAX package's ``dist/collectives.py``.

SVE exposes BOTH a strictly-ordered floating-point reduction (``fadda``) and
a pairwise-tree one (``faddv``); the same two orderings reappear here as
collectives, plus an int8 error-feedback compressed variant for gradient
traffic.  Each takes this rank's block and a process group (None: the
world), where the JAX functions take a shard_map axis name.

A gloo group moves host tensors: a card's tensor is staged through the
host and its result copied back (ranks that share one card run gloo, see
``launch.mesh``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

#: reduction orderings selectable at launch: "fast" is the backend's native
#: all-reduce (scheduling-dependent association), "ordered"/"pairwise" are
#: the fadda/faddv orderings below.
PSUM_MODES = ("fast", "ordered", "pairwise")

_PSUM_MODE = "fast"

# observability hook (repro_torch.obs): when set, each ``psum`` call bumps a
# ``psum_<mode>_calls`` counter, and each of training's collectives below
# (``reduce_scatter``, ``sum_scalars``) a ``<name>_calls`` counter.  It
# counts CALLS, each one a collective that ran; the JAX package's counter
# counts traced calls (a census of the orderings its compiled programs bake
# in).  Wire from ``launch/serve.py --metrics`` via ``set_obs``.
_OBS = None


def set_obs(obs) -> None:
    """Attach an ``repro_torch.obs.Obs`` whose registry counts psum calls by
    mode (None detaches)."""
    global _OBS
    _OBS = obs


def set_psum_mode(mode: str) -> None:
    """Select the ordering ``psum`` dispatches to (process-wide choice point;
    wire from ``launch/serve.py --psum``)."""
    if mode not in PSUM_MODES:
        raise ValueError(f"psum mode {mode!r} not in {PSUM_MODES}")
    global _PSUM_MODE
    _PSUM_MODE = mode


def psum_mode() -> str:
    return _PSUM_MODE


def _staged(x, group):
    """``x`` as the group's backend takes it: for gloo a card's tensor is
    copied into pinned host memory (which PyTorch's caching host allocator
    hands out again), so the copies both ways run at the link's rate."""
    if dist.get_backend(group) == "gloo" and x.device.type != "cpu":
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host
    return x.contiguous()


def _like(xs):
    """An empty buffer for a peer's ``xs``: pinned where ``xs`` is."""
    if xs.is_pinned():
        return torch.empty(xs.shape, dtype=xs.dtype, pin_memory=True)
    return torch.empty_like(xs)


def all_gather(x, group=None, dim: int = 0):
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order, on
    every rank (on ``x``'s device)."""
    xs = _staged(x, group)
    parts = [_like(xs) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, xs, group=group)
    if xs.device == x.device:
        return torch.cat(parts, dim=dim)
    # each part straight into its slice of the card's result
    shape = list(x.shape)
    shape[dim] *= len(parts)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    for i, part in enumerate(parts):
        out.narrow(dim, i * x.shape[dim], x.shape[dim]).copy_(part)
    return out


def _stacked(x, group):
    """(N, ...) every rank's ``x``, identical on every rank."""
    return all_gather(x.unsqueeze(0), group, 0)


def psum(x, group=None, mode: str | None = None):
    """The serve-path reduction choice point: one name model code can call,
    resolving to the native all-reduce or a deterministic ordering.  Each
    call runs under a ``psum_<mode>`` ``record_function`` range (the JAX
    package's named_scope), so a profile attributes collective cost to the
    ordering that produced it."""
    mode = _PSUM_MODE if mode is None else mode
    if _OBS is not None:
        _OBS.metrics.inc(f"psum_{mode}_calls")
    with torch.profiler.record_function(f"psum_{mode}"):
        if mode == "ordered":
            return ordered_psum(x, group)
        if mode == "pairwise":
            return pairwise_psum(x, group)
        return _all_reduce(x, group)


def _count(name: str) -> None:
    if _OBS is not None:
        _OBS.metrics.inc(f"{name}_calls")


def reduce_scatter(x, group=None, dim: int = 0):
    """The sum of every rank's ``x`` over the group, cut along ``dim`` into
    group-size blocks in group-rank order: this rank's block (the FSDP
    gradient).  Each block is gathered to the rank that owns it (one
    ``gather`` a rank: every rank sends each other rank only that rank's
    block) and summed there left to right over the ranks from zero, as
    ``ordered_psum`` (in f32 for a narrower dtype, rounded once at the
    end): the bits of one fixed order whatever the backend."""
    _count("reduce_scatter")
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    xs = _staged(x, group)
    mine = None
    for i in range(n):
        part = xs.narrow(dim, i * size, size).contiguous()
        bufs = [_like(part) for _ in range(n)] if i == r else None
        dst = i if group is None else dist.get_global_rank(group, i)
        dist.gather(part, bufs, dst=dst, group=group)
        if i == r:
            mine = bufs
    acc = torch.zeros_like(mine[0], dtype=torch.promote_types(
        mine[0].dtype, torch.float32))
    for b in mine:
        acc = acc + b
    return acc.to(device=x.device, dtype=x.dtype)


def sum_scalars(x, group=None):
    """The sum of a small tensor (a token count, a norm's squares, an aux
    loss's partial sums) over the group (None: the whole mesh), left to
    right over the ranks: the same bits on every rank."""
    _count("sum_scalars")
    return ordered_psum(x, group)


def _all_reduce(x, group):
    """The backend's native sum over the group (its own association)."""
    y = _staged(x, group).clone()
    dist.all_reduce(y, group=group)
    return y.to(x.device)


def ordered_psum(x, group=None):
    """Strictly-ordered sum over the group: bit-identical to a sequential
    left-to-right loop over ranks from zero (the cross-device ``fadda``).

    Costs an all-gather instead of an all-reduce — ordering is bought with
    bandwidth, exactly the fadda/faddv trade of the paper.
    """
    xs = _stacked(x, group)
    acc = torch.zeros_like(xs[0])
    for i in range(xs.shape[0]):
        acc = acc + xs[i]
    return acc


def pairwise_psum(x, group=None):
    """Deterministic pairwise-tree sum (the cross-device ``faddv``): fixed
    balanced-tree association independent of scheduling, error O(log N)."""
    xs = _stacked(x, group)
    while xs.shape[0] > 1:
        n = xs.shape[0]
        half = n // 2
        paired = xs[: 2 * half].reshape((half, 2) + xs.shape[1:]).sum(dim=1)
        if n % 2:
            paired = torch.cat([paired, xs[-1:]], dim=0)
        xs = paired
    return xs[0]


def compressed_psum(g, group, err):
    """int8-quantized mean with per-rank error feedback.

    Each rank quantizes (g + err) to int8 against its own absmax scale; the
    quantization residual is carried into the next round, so the accumulated
    mean over repeated rounds converges to the exact mean (the residual
    telescopes).  Returns (mean, new_err).
    """
    comp = g + err
    scale = torch.clamp(comp.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(comp / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    new_err = comp - deq
    mean = _all_reduce(deq, group) / dist.get_world_size(group)
    return mean, new_err
