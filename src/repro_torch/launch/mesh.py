"""Process meshes over ``torch.distributed``: the counterpart of the JAX
launcher's ``launch/mesh.py``.

A JAX mesh is an array of the devices one process drives.  Here a mesh is
a grid of PROCESSES (ranks), one per shard: each rank holds its own block
of every sharded tensor and drives one device.  Ranks lie on the grid in
row-major order over its axes, and each axis has one process group per
line of ranks along it (``Mesh.groups``), whose group ranks follow the
axis coordinate.

The world size is the number of processes, so JAX's ``force_host_devices``
(forcing host devices in one process) has no counterpart: to run a mesh on
the CPU, start more ranks (``run_ranks``).

The backend is NCCL when every rank has a card of its own.  It is gloo on
the CPU, and gloo also when ranks share one card, since NCCL refuses two
ranks on one device; gloo's collectives then run on the host
(``dist.collectives`` stages a card's tensors through it).  ``make_mesh``
prints which backend it found and why.

Nothing here touches CUDA, starts a process or creates a group at import.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import tempfile
import time
import traceback
import warnings
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.device import resolve_device

#: seconds a collective may wait for its peers before the group fails
GROUP_TIMEOUT_S = 600.0
#: the axes request lanes are cut over, folded (``dist.sharding``'s "batch"
#: rule)
BATCH_AXES = ("pod", "data")


def parse_mesh(spec: str) -> tuple[int, int]:
    """Parse a ``--mesh DxM`` spec ("4x2" -> (4, 2)): data axis x model axis."""
    try:
        d, m = spec.lower().split("x")
        d, m = int(d), int(m)
    except ValueError:
        raise ValueError(f"mesh spec {spec!r} is not DxM (e.g. '4x2')")
    if d < 1 or m < 1:
        raise ValueError(f"mesh spec {spec!r} must have positive axes")
    return d, m


@dataclasses.dataclass
class Mesh:
    """This rank's view of a process mesh.  ``shape`` maps each axis name to
    its size and ``axis_names`` orders them, as a JAX mesh's do, so
    ``dist.sharding.spec_for`` reads either; ``coords`` is this rank's
    coordinate on each axis and ``groups`` the process group of its line
    along each axis, and under "batch" of its line over the folded lane
    axes (pod x data)."""
    axis_names: tuple
    shape: dict
    coords: dict
    groups: dict
    backend: str
    device: torch.device
    rank: int


def rank_device(device, rank: int, world: int) -> torch.device:
    """The device rank ``rank`` drives: ``cuda:rank`` when every rank has a
    card of its own, ``cuda:0`` when the ranks share one, the CPU when asked
    for.  Raises without CUDA unless the CPU is asked for."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank if torch.cuda.device_count() >= world
                        else 0)


def choose_backend(device, world: int) -> tuple[str, str]:
    """(backend, why) for ``world`` ranks on ``device``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "gloo", "the ranks run on the CPU"
    n = torch.cuda.device_count()
    if n >= world:
        return "nccl", f"each of the {world} ranks has a card of its own"
    return "gloo", (f"{world} ranks share {n} card(s) and NCCL refuses two "
                    "ranks on one device; collectives run on the host")


def make_mesh(shape, axes, *, device=None) -> Mesh:
    """The mesh of ``shape`` over ``axes`` on the initialised default group,
    whose world size must be the mesh's size.  Every rank must call it (it
    creates the axes' groups, which is collective)."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise RuntimeError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                           f"group has {world}")
    dev = rank_device(device, rank, world)
    coords, rest = {}, rank
    for ax, n in reversed(list(zip(axes, shape))):
        coords[ax], rest = rest % n, rest // n
    groups = {}
    for i, ax in enumerate(axes):
        stride = math.prod(shape[i + 1:])
        # every line along ``ax``: the ranks that differ only in ax's
        # coordinate, in that coordinate's order (every rank makes every
        # group, in one order)
        starts = [r for r in range(world) if (r // stride) % shape[i] == 0]
        for s in starts:
            line = [s + j * stride for j in range(shape[i])]
            g = dist.new_group(line)
            if rank in line:
                groups[ax] = g
    # "batch": the line over the folded lane axes (pod x data, row-major),
    # the group request lanes are gathered over
    folded = [i for i, ax in enumerate(axes) if ax in BATCH_AXES]
    if len(folded) == 1:
        groups["batch"] = groups[axes[folded[0]]]
    elif folded:
        lines: dict = {}
        for r in range(world):
            c = [(r // math.prod(shape[i + 1:])) % shape[i]
                 for i in range(len(axes))]
            key = tuple(c[i] for i in range(len(axes)) if i not in folded)
            lines.setdefault(key, []).append(r)
        for key in sorted(lines):
            g = dist.new_group(lines[key])
            if rank in lines[key]:
                groups["batch"] = g
    backend = dist.get_backend()
    if rank == 0:
        why = choose_backend(device, world)[1]
        print(f"[mesh] {dict(zip(axes, shape))} over {world} rank(s), backend "
              f"{backend} ({why}), rank 0 on {dev}", flush=True)
    return Mesh(axes, dict(zip(axes, shape)), coords, groups, backend, dev,
                rank)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The full-scale mesh ((data 16, model 16), with an outer "pod" axis of
    2 when ``multi_pod``) or, over fewer ranks, the largest mesh the world
    size allows (axes halved largest-first, with a warning), over the
    initialised default group."""
    shape = [2, 16, 16] if multi_pod else [16, 16]
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size()
    want = math.prod(shape)
    if world < want:
        while math.prod(shape) > world:
            i = max(range(len(shape)), key=lambda j: shape[j])
            if shape[i] == 1:
                break
            shape[i] //= 2
        warnings.warn(
            f"{want}-rank production mesh degraded to {tuple(shape)} over "
            f"{axes} ({world} ranks; start more ranks for the full mesh)",
            RuntimeWarning, stacklevel=2)
    if math.prod(shape) != world:
        raise RuntimeError(f"the production mesh {tuple(shape)} needs "
                           f"{math.prod(shape)} ranks, the group has {world}")
    return make_mesh(shape, axes, device=device)


def batch_shard_count(mesh) -> int:
    """Number of ways the batch/token axis is sharded (pod x data)."""
    n = 1
    for ax in BATCH_AXES:
        if ax in mesh.axis_names:
            n *= mesh.shape[ax]
    return n


def join_group(shape, axes, *, device=None) -> Mesh:
    """Join the group a launcher such as ``torchrun`` describes in the
    environment (``env://``: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) and
    build the mesh over it."""
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    dev = rank_device(device, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(choose_backend(device, world)[0],
                            init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return make_mesh(shape, axes, device=device)


def _rank_main(rank, shape, axes, device, store, out, fn, args):
    """One rank: join the FileStore group, build the mesh, run ``fn(mesh,
    *args)`` and pickle its result to ``out/rank<r>.pkl``; a failure's
    traceback goes to ``out/rank<r>.err`` and the rank exits non-zero."""
    world = math.prod(shape)
    try:
        # the ranks share the host's cores: one intra-op thread each
        torch.set_num_threads(1)
        dev = rank_device(device, rank, world)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            choose_backend(device, world)[0],
            store=dist.FileStore(store, world), rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        result = fn(make_mesh(shape, axes, device=device), *args)
        with open(Path(out) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        (Path(out) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, shape, axes, *args, device=None,
              timeout: Optional[float] = 900.0) -> list:
    """Start one rank per point of the mesh ``shape`` over ``axes``
    (``torch.multiprocessing``'s spawn start: CUDA does not survive a fork),
    each joining one group through a ``FileStore`` in a fresh temporary
    directory (no TCP port), and run ``fn(mesh, *args)`` on every rank.
    ``fn`` must be importable by name (spawn pickles it so); its result must
    pickle.  Returns the ranks' results in rank order.

    The join has a deadline of ``timeout`` seconds (None: none).  When a
    rank fails, the deadline passes or this process is interrupted, the
    other ranks are killed, and this raises with the failing rank's
    traceback.  The device is refused before any rank starts (no CUDA and
    no ``device="cpu"``)."""
    resolve_device(device)
    world = math.prod(shape)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, tuple(shape), tuple(axes), device,
                                   os.path.join(d, "store"), d, fn, args))
                 for r in range(world)]
        deadline = None if timeout is None else time.monotonic() + timeout
        failed = None
        try:
            for p in procs:
                p.start()
            while any(p.exitcode is None for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.exitcode not in (None, 0)), None)
                if failed is not None or (deadline is not None
                                          and time.monotonic() > deadline):
                    break
                time.sleep(0.05)
            else:
                failed = next((r for r, p in enumerate(procs)
                               if p.exitcode != 0), None)
        finally:
            for p in procs:
                if p.pid is not None and p.exitcode is None:
                    p.kill()
            for p in procs:
                if p.pid is not None:
                    p.join(10)
        if failed is not None:
            err = Path(d) / f"rank{failed}.err"
            why = (err.read_text() if err.exists()
                   else f"exit code {procs[failed].exitcode}")
            raise RuntimeError(f"rank {failed} of {world} failed:\n{why}")
        if any(p.exitcode != 0 for p in procs):
            raise TimeoutError(f"{world} ranks did not finish within "
                               f"{timeout:.0f} s")
        out = []
        for r in range(world):
            with open(Path(d) / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
