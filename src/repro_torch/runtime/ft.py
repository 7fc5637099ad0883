"""Fault tolerance, mirroring ``repro.runtime.ft``: a checkpoint/restart
training loop and a straggler watchdog, over the port's tensor state.

* Recovery: the loop catches step failures (injected in tests; in the field
  device loss or preemption), restores the last committed checkpoint,
  rebuilds the data stream at the restored step (the pipeline is stateless
  in step: ``data.pipeline``) and continues.  Repeated failures at the same
  point back off and eventually re-raise.
* Straggler watchdog: per-step wall times feed an EWMA; steps slower than
  ``threshold`` x the EWMA are flagged (logged and kept in ``flagged``).

The port's train step updates its state in place, so the state a run
started from is gone once it has taken a step: where no checkpoint exists
yet, the loop commits the starting state as one (step ``start``) before
its first step, and a fault before the first periodic checkpoint restores
that.  Re-meshing on restore waits for the port's mesh (ROADMAP Queue 1
item 14).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)

log = logging.getLogger("repro_torch.ft")


@dataclass
class StragglerWatchdog:
    """EWMA step-time monitor; flags steps slower than threshold x EWMA."""
    alpha: float = 0.1
    threshold: float = 2.0
    warmup_steps: int = 5
    ewma: Optional[float] = None
    seen: int = 0
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.seen += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = (self.seen > self.warmup_steps
                        and dt > self.threshold * self.ewma)
        if is_straggler:
            self.flagged.append((step, dt, self.ewma))
            log.warning("straggler: step %d took %.3fs (ewma %.3fs)",
                        step, dt, self.ewma)
        else:
            # stragglers do not poison the EWMA
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


class FaultTolerantLoop:
    """Checkpoint/restart training loop.

    train_step: (state, batch) -> (state, metrics)
    batch_fn:   step -> batch           (stateless; restart-safe)
    save_every: checkpoint cadence (async, atomic)
    """

    def __init__(self, train_step: Callable, batch_fn: Callable, *,
                 ckpt_dir: str, save_every: int = 50, max_retries: int = 3):
        self.train_step = train_step
        self.batch_fn = batch_fn
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.max_retries = max_retries
        self.ckpt = AsyncCheckpointer(ckpt_dir)
        self.watchdog = StragglerWatchdog()
        self.recoveries = 0

    def resume_or(self, init_state):
        step = latest_step(self.ckpt_dir)
        if step is None:
            return init_state, 0
        state, step = restore_checkpoint(self.ckpt_dir, init_state)
        log.info("resumed from step %d", step)
        return state, step

    def run(self, init_state, num_steps: int, *, metrics_cb=None,
            fault_injector=None):
        """Run to ``num_steps``, surviving step failures via restore.
        Returns (state, history of (step, loss))."""
        state, start = self.resume_or(init_state)
        if latest_step(self.ckpt_dir) is None:
            self.ckpt.save(start, state)      # the state a restore falls back to
        step = start
        retries = 0
        fault_step = -1          # retries reset only once we pass this step
        history = []
        while step < num_steps:
            try:
                if fault_injector is not None:
                    fault_injector(step)          # tests: raise here
                batch = self.batch_fn(step)
                t0 = time.time()
                state, metrics = self.train_step(state, batch)
                # block on the loss so step time is real, and NaN-check it
                loss = float(metrics["loss"])
                dt = time.time() - t0
                if loss != loss:
                    raise FloatingPointError(f"NaN loss at step {step}")
                self.watchdog.observe(step, dt)
                history.append((step, loss))
                if metrics_cb:
                    metrics_cb(step, metrics)
                step += 1
                if step > fault_step:
                    # genuine progress past the last failure point: a
                    # PERSISTENT fault must not be reset by replayed steps
                    retries = 0
                if step % self.save_every == 0:
                    self.ckpt.save(step, state)
            except Exception as e:  # noqa: BLE001 - recovery path
                self.recoveries += 1
                retries += 1
                fault_step = max(fault_step, step)
                log.warning("step %d failed (%r); restoring (retry %d/%d)",
                            step, e, retries, self.max_retries)
                if retries > self.max_retries:
                    raise
                self.ckpt.wait()
                state, step = restore_checkpoint(self.ckpt_dir, init_state)
                time.sleep(0.01 * retries)        # backoff (scaled down)
        self.ckpt.wait()
        self.ckpt.save(step, state)
        self.ckpt.wait()
        return state, history
