"""The port's checkpoints and fault-tolerant loop (``repro_torch.checkpoint``,
``repro_torch.runtime``): the round trip bit for bit (f32, bf16 as raw bits,
int 0-d leaves), the on-disk layout shared with the JAX package (each reads
the other's f32 checkpoints), ``.tmp`` ignored, the async writer's host copy
and garbage collection; the loop resuming, recovering from injected faults
to the bits of an uninterrupted run, giving up after ``max_retries``, and
the straggler watchdog."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.data import SyntheticLM
from repro_torch.runtime import FaultTolerantLoop, StragglerWatchdog
from repro_torch.train import make_train_step
from repro_torch.train.step import state_from
from torch_parity import plain_models

torch.set_num_threads(1)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 4, generator=g).requires_grad_(),
                       "b": torch.randn(5, generator=g).to(torch.bfloat16)},
            "opt": {"count": torch.tensor(7, dtype=torch.int32)},
            "step": torch.tensor(3, dtype=torch.int32)}


def _equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_equal(a[k], b[k]) for k in a)
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(-1).view(torch.uint8) if a.dim() else a,
                            b.view(-1).view(torch.uint8) if b.dim() else b)
            and a.requires_grad == b.requires_grad)


def test_round_trip_and_layout(tmp_path):
    tree = _tree()
    d = save_checkpoint(str(tmp_path), 12, tree)
    assert os.path.basename(d) == "step_00000012"
    files = sorted(os.listdir(d))
    assert files == ["leaf_00000.npy", "leaf_00001.npy", "leaf_00002.npy",
                     "leaf_00003.npy", "manifest.json"]
    man = json.load(open(os.path.join(d, "manifest.json")))
    # sorted keys at every level, as JAX flattens a dict
    assert man["keys"] == ["['opt']['count']", "['params']['b']",
                           "['params']['w']", "['step']"]
    assert man["dtypes"] == ["int32", "bfloat16", "float32", "int32"]
    assert np.load(os.path.join(d, "leaf_00001.npy")).dtype == np.int16
    like = _tree(1)
    got, step = restore_checkpoint(str(tmp_path), like)
    assert step == 12 and _equal(got, tree)
    # each dict in the order of ``like`` (the step's global norm sums in it)
    assert list(got) == list(like) and list(got["params"]) == ["w", "b"]
    with pytest.raises(ValueError, match="structure"):
        restore_checkpoint(str(tmp_path), {"a": tree["step"]})


def test_checkpoints_cross_read_with_jax(tmp_path):
    """An f32 tree saved by either package restores in the other."""
    rng = np.random.RandomState(0)
    tree_np = {"b": {"x": rng.randn(2, 3).astype(np.float32)},
               "a": rng.randn(4).astype(np.float32)}
    jax_save(str(tmp_path / "j"), 5, tree_np)
    like = {"b": {"x": torch.zeros(2, 3)}, "a": torch.zeros(4)}
    got, step = restore_checkpoint(str(tmp_path / "j"), like)
    assert step == 5
    assert torch.equal(got["a"], torch.from_numpy(tree_np["a"]))
    assert torch.equal(got["b"]["x"], torch.from_numpy(tree_np["b"]["x"]))
    save_checkpoint(str(tmp_path / "t"), 6, got)
    back, step = jax_restore(str(tmp_path / "t"), tree_np)
    assert step == 6
    np.testing.assert_array_equal(np.asarray(back["b"]["x"]), tree_np["b"]["x"])


def test_tmp_ignored_and_async_gc(tmp_path):
    ck = str(tmp_path)
    assert latest_step(ck) is None
    save_checkpoint(ck, 2, _tree())
    os.makedirs(os.path.join(ck, "step_00000009.tmp"))     # a torn save
    assert latest_step(ck) == 2
    writer = AsyncCheckpointer(ck, keep=2)
    tree = _tree()
    for s in (3, 4, 5):
        saved = tree["params"]["w"].detach().clone()
        writer.save(s, tree)
        tree["params"]["w"].data.add_(1.0)   # after save: the copy is taken
    writer.wait()
    assert sorted(n for n in os.listdir(ck) if not n.endswith(".tmp")) == [
        "step_00000004", "step_00000005"]
    got, step = restore_checkpoint(ck, tree)
    assert step == 5
    assert torch.equal(got["params"]["w"], saved)


def _dense_run(tmp_path, name, steps, fault_at=(), save_every=3):
    _, _, cfg, model = plain_models(0)
    data = SyntheticLM(cfg.vocab_size, 16, seed=0, mean_doc_len=12)

    def batch_fn(s):
        tokens, labels, lens = data.batch(s, 2)
        return {"tokens": torch.from_numpy(tokens),
                "labels": torch.from_numpy(labels), "lens": torch.from_numpy(lens)}
    pending = set(fault_at)

    def inject(step):
        if step in pending:
            pending.discard(step)
            raise RuntimeError(f"injected fault at step {step}")
    loop = FaultTolerantLoop(make_train_step(cfg, peak_lr=1e-2, warmup=2, total=20),
                             batch_fn, ckpt_dir=str(tmp_path / name),
                             save_every=save_every)
    state, hist = loop.run(state_from(model), steps, fault_injector=inject)
    return state, hist, loop


def test_loop_recovers_to_the_uninterrupted_bits(tmp_path):
    """Faults at steps 1 (before the first periodic checkpoint: restores the
    starting state) and 7 (restores step 6): the final state equals an
    uninterrupted run's bit for bit; a second run resumes at the end."""
    want, hist_w, _ = _dense_run(tmp_path, "clean", 9)
    got, hist, loop = _dense_run(tmp_path, "faulty", 9, fault_at=(1, 7))
    assert loop.recoveries == 2
    assert [s for s, _ in hist] == [0, 0, 1, 2, 3, 4, 5, 6, 6, 7, 8]
    assert hist[-1] == hist_w[-1]
    assert _equal(got["params"], want["params"])
    assert int(got["step"]) == 9
    _, again, _ = _dense_run(tmp_path, "faulty", 9)
    assert again == []                       # resumed at step 9: nothing to do


def test_loop_gives_up_after_max_retries(tmp_path):
    calls = []

    def step(state, batch):
        calls.append(batch)
        return {"x": state["x"] + 1}, {"loss": torch.tensor(float("nan"))
                                       if batch == 2 else torch.tensor(1.0)}
    loop = FaultTolerantLoop(step, lambda s: s, ckpt_dir=str(tmp_path),
                             save_every=2, max_retries=2)
    with pytest.raises(FloatingPointError, match="NaN loss at step 2"):
        loop.run({"x": torch.zeros(())}, 5)
    assert loop.recoveries == 3 and calls == [0, 1, 2, 2, 2]


def test_straggler_watchdog():
    wd = StragglerWatchdog(threshold=2.0, warmup_steps=3)
    flags = [wd.observe(s, dt) for s, dt in
             enumerate([1.0, 1.0, 1.0, 5.0, 1.0, 5.0, 1.1])]
    # from the 4th step on (seen > 3), a step over 2x the EWMA is flagged
    # and kept out of the EWMA
    assert flags == [False, False, False, True, False, True, False]
    assert [s for s, _, _ in wd.flagged] == [3, 5]
    assert wd.ewma == pytest.approx(0.9 * 1.0 + 0.1 * 1.1)
