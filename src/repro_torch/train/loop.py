"""Fault-tolerant training loop, as the JAX package's ``train/loop.py``.

* checkpoint/restart — cadence saves via ``Checkpointer``; any step failure
  triggers restore-from-LATEST and replay (idempotent because the data
  pipeline is step-indexed, not stateful);
* failure injection — ``FailureInjector`` raises simulated device losses
  so the restart path is exercised deterministically;
* straggler mitigation — a step deadline (measured against a rolling
  median) marks slow steps; after ``patience`` consecutive stragglers the
  loop re-checkpoints and records the event;
* crash-only design — the loop never needs clean shutdown; LATEST is
  always consistent (ckpt.py's atomic rename).

A step's clock stops after the card has finished it (a synchronise on
the loss's device).  In a ``torch.distributed`` world of several ranks
(a sharded step) every rank runs the loop: checkpoints are collective
saves (``checkpoint.ckpt``), a restore puts each leaf back on its
placements, and the straggler policy sees the slowest rank's step time,
so all ranks take the same decision.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.obs.trace import block_until_ready


class SimulatedDeviceLoss(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Deterministically fail specific steps (once each)."""

    fail_at: tuple = ()
    _fired: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise SimulatedDeviceLoss(f"injected failure at step {step}")


@dataclass
class StragglerPolicy:
    """Deadline-based straggler detection on step wall time."""

    slack: float = 3.0            # step is a straggler at slack x median
    patience: int = 3
    window: int = 32
    _times: list = field(default_factory=list)
    _consecutive: int = 0
    events: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Returns True when mitigation should fire."""
        self._times.append(dt)
        self._times = self._times[-self.window:]
        if len(self._times) < 8:
            return False
        med = float(np.median(self._times[:-1]))
        if dt > self.slack * med:
            self._consecutive += 1
            self.events.append({"step": step, "dt": dt, "median": med})
        else:
            self._consecutive = 0
        if self._consecutive >= self.patience:
            self._consecutive = 0
            return True
        return False


def _slowest(dt: float, like) -> float:
    """The largest of the ranks' step times (one all-reduce on ``like``'s
    device) in a world of several; ``dt`` elsewhere."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return dt
    t = torch.tensor([dt], dtype=torch.float64, device=like.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def train_loop(*, init_state_fn: Callable, train_step: Callable,
               batch_fn: Callable, n_steps: int,
               checkpointer: Optional[Checkpointer] = None,
               failure_injector: Optional[FailureInjector] = None,
               straggler: Optional[StragglerPolicy] = None,
               max_restarts: int = 8,
               log_every: int = 10,
               metrics_cb: Optional[Callable] = None):
    """Run ``n_steps``, surviving injected failures.  Returns (state,
    history dict).  A restore puts each leaf where ``init_state_fn``'s
    state has it."""
    restarts = 0
    history = {"loss": [], "restarts": 0, "straggler_events": 0,
               "checkpoints": 0}

    def boot():
        if checkpointer is not None:
            state, step = checkpointer.restore_or_init(init_state_fn)
            return state, int(step)
        return init_state_fn(), 0

    state, start = boot()
    step = start
    while step < n_steps:
        try:
            batch = batch_fn(step)
            t0 = time.perf_counter()
            if failure_injector is not None:
                failure_injector.check(step)
            state, metrics = train_step(state, batch)
            block_until_ready(metrics["loss"])
            dt = time.perf_counter() - t0
            loss = float(metrics["loss"])
            history["loss"].append(loss)
            if metrics_cb:
                metrics_cb(step, metrics, dt)
            if log_every and step % log_every == 0:
                print(f"step {step:6d} loss {loss:.4f} {dt*1e3:.1f} ms",
                      flush=True)
            if straggler is not None and straggler.observe(
                    step, _slowest(dt, metrics["loss"])):
                history["straggler_events"] += 1
                if checkpointer is not None:
                    checkpointer.maybe_save(step + 1, state, force=True)
                    history["checkpoints"] += 1
            step += 1
            if checkpointer is not None:
                if checkpointer.maybe_save(step, state):
                    history["checkpoints"] += 1
        except SimulatedDeviceLoss as e:
            restarts += 1
            history["restarts"] = restarts
            if restarts > max_restarts:
                raise RuntimeError("restart budget exhausted") from e
            print(f"[ft] {e} -> restoring from last checkpoint", flush=True)
            state, step = boot()
    if checkpointer is not None:
        checkpointer.maybe_save(step, state, force=True)
        history["checkpoints"] += 1
    return state, history
