"""Checkpointing, mirroring ``repro.checkpoint.ckpt``: per-leaf .npy files +
manifest, atomic commit, async save with garbage collection.

Layout (the JAX package's):
    <dir>/step_<n>.tmp/...   (being written)
    <dir>/step_<n>/leaf_00000.npy ... manifest.json   (committed via rename)

A tree is nested dicts of tensors; its leaves are numbered in sorted-key
order at every level, as JAX flattens a dict, and the manifest names each
leaf by its key path (``['params']['embed.tok']``) and its dtype.  A bf16
leaf is stored as its raw 16 bits (numpy has no bfloat16) and restored by
its manifest dtype.  The atomic rename means a fault mid-save never corrupts
the latest checkpoint: restore picks the highest committed step.  Restoring
onto another mesh (JAX's ``shardings``) waits for the port's mesh (ROADMAP
Queue 1 item 14).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _leaves(tree, path=""):
    """(key path, leaf) in JAX's flattening order (sorted dict keys)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{path}[{k!r}]")
        return out
    return [(path, tree)]


def _rebuild(like, by_path: dict, path=""):
    """``like``'s structure, its dicts in their own key order (the train
    step's global norm sums the leaves in that order), each leaf taken from
    ``by_path`` by its key path."""
    if isinstance(like, dict):
        return {k: _rebuild(v, by_path, f"{path}[{k!r}]")
                for k, v in like.items()}
    return by_path[path]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Blocking save with atomic commit.  Returns the committed directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves = _leaves(tree)
    manifest = {"step": int(step), "n_leaves": len(leaves),
                "keys": [k for k, _ in leaves],
                "dtypes": [_dtype_name(t) for _, t in leaves]}
    for i, (_, leaf) in enumerate(leaves):
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), _to_numpy(leaf))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic commit
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name[5:]))
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, like: Any, *, step: Optional[int] = None,
                       device=None) -> tuple[Any, int]:
    """Restore into the structure of ``like`` (its leaves' shapes, dtypes
    and ``requires_grad``), onto ``device`` (default: each leaf's of
    ``like``).  Returns (tree, step).  A manifest without dtypes (the JAX
    package writes none) restores each leaf from its array's own dtype."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves = _leaves(like)
    if manifest["n_leaves"] != len(like_leaves):
        raise ValueError(f"structure mismatch: {manifest['n_leaves']} leaves "
                         f"on disk, {len(like_leaves)} in the tree")
    out = []
    for i, (key, leaf) in enumerate(like_leaves):
        arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
        t = torch.from_numpy(arr)
        if manifest.get("dtypes", [None] * len(like_leaves))[i] == "bfloat16":
            t = t.view(torch.bfloat16)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"leaf {i} {key}: {tuple(t.shape)} vs "
                             f"{tuple(leaf.shape)}")
        # a copy in torch's own allocation: np.load's buffer may sit on
        # another alignment, and the CPU kernels' vector loops (their sums'
        # order) follow the alignment
        t = t.to(device=leaf.device if device is None else device,
                 dtype=leaf.dtype, copy=True)
        out.append(t.requires_grad_(leaf.requires_grad))
    return _rebuild(like, {k: t for (k, _), t in zip(like_leaves, out)}), step


class AsyncCheckpointer:
    """Background-thread checkpoint writer.

    ``save`` copies the tree to the host synchronously (the training step
    updates its state in place, so the writer must own its bytes), then the
    serialization happens off-thread; ``wait`` joins the last write.  After
    each write only the newest ``keep`` committed steps are kept."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any):
        self.wait()
        host = _rebuild(tree, {k: t.detach().to("cpu", copy=True)
                               for k, t in _leaves(tree)})

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(n[5:]) for n in os.listdir(self.ckpt_dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
