"""Fault-tolerant training loop: the port of
``repro.runtime.fault_tolerance``.

Hadoop gave the paper re-execution of failed tasks for free; the SPMD analogue
is (a) frequent async checkpoints, (b) a NaN/inf step guard that skips poisoned
updates (the paper's noisy-data concern, §III-A), and (c) deterministic resume:
after a crash the loop restores the last checkpoint, fast-forwards the data
cursor, and replays the identical stream.  Straggler mitigation lives in the
pipeline prefetch + the hierarchical reduce (see core.mapreduce).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterator, Optional

from ..checkpoint import ckpt


@dataclasses.dataclass
class LoopConfig:
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    async_save: bool = True
    max_bad_steps: int = 10           # consecutive non-finite steps before abort
    log_every: int = 10
    resume: bool = True


class TrainLoop:
    """Wraps a ``step(state, batch) -> (state, metrics)`` with
    checkpoint/restart + NaN-guard.  ``state`` is any tree (dicts, lists,
    tuples) of tensors that includes the params/optimizer; ``metrics`` must
    include a scalar 'loss'.  The guard keeps the state from before a
    non-finite step, so ``step`` must not update its input in place
    (``optim.apply_updates`` returns new tensors).  A resumed state lands
    on ``device`` (default: the device of each leaf of ``state``)."""

    def __init__(self, step_fn: Callable, state, data: Iterator,
                 cfg: LoopConfig, *, device=None):
        self.step_fn = step_fn
        self.state = state
        self.data = data
        self.cfg = cfg
        self.step = 0
        self.bad_streak = 0
        self._pending_save = None
        self.history: list = []
        if cfg.resume and cfg.ckpt_dir and ckpt.latest_step(cfg.ckpt_dir) is not None:
            self.state, self.step, extra = ckpt.restore(
                cfg.ckpt_dir, self.state, device=device)
            print(f"[loop] resumed from step {self.step}")

    def run(self, n_steps: int) -> Dict[str, Any]:
        cfg = self.cfg
        t0 = time.perf_counter()
        it = iter(self.data)
        # deterministic resume: fast-forward the stream to the cursor
        for _ in range(self.step):
            next(it)
        target = self.step + n_steps
        while self.step < target:
            batch = next(it)
            new_state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])
            if not math.isfinite(loss):
                # NaN guard: drop the update, keep counting
                self.bad_streak += 1
                print(f"[loop] step {self.step}: non-finite loss ({loss}); "
                      f"update skipped ({self.bad_streak}/{cfg.max_bad_steps})")
                if self.bad_streak >= cfg.max_bad_steps:
                    raise RuntimeError("too many consecutive non-finite steps")
                self.step += 1
                continue
            self.bad_streak = 0
            self.state = new_state
            self.step += 1
            self.history.append(loss)
            if cfg.log_every and self.step % cfg.log_every == 0:
                dt = time.perf_counter() - t0
                print(f"[loop] step {self.step} loss {loss:.4f} "
                      f"({dt / max(1, len(self.history)):.3f}s/step)")
            if cfg.ckpt_dir and self.step % cfg.ckpt_every == 0:
                self._save()
        if cfg.ckpt_dir:
            self._save()
            if self._pending_save is not None:
                self._pending_save.join()
        return {"final_loss": self.history[-1] if self.history else float("nan"),
                "steps": self.step, "history": self.history}

    def _save(self):
        if self._pending_save is not None:
            self._pending_save.join()    # keep at most one in flight
        self._pending_save = ckpt.save(
            self.cfg.ckpt_dir, self.step, self.state,
            extra={"time": time.time()}, _async=self.cfg.async_save)
