"""Deterministic fault injection for the serving Scheduler, and the
training loop's watchdog and restarts.

Counterpart of the JAX package's `runtime/fault.py` (`FaultPlan`,
`CrashInjected`, `FaultState`, `StepWatchdog`, `run_restartable`): a plan
fires from the same `numpy.random.RandomState(seed)` stream, in the same
query order and under the same `max_faults` cap, so one plan fires at the
same scheduler queries in both packages.  Neither `crash_at_step` nor
`bitflip_spilled_page_steps` draws from the stream, so a plan with or
without them fires its rate faults at the same queries.
`run_restartable` resumes a training run from the newest intact
checkpoint generation after any exception in a step; the data of a step
comes from its index, so nothing else needs saving.  Elastic meshes are
ROADMAP.md §1 item 9.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import checkpoint as ckpt


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Which failure modes fire and when; the Scheduler queries the plan at
    fixed hook points, so each fault runs a real recovery path:

      * force-evict: evict the normal victim at step s (spill and restore,
        or a recompute continuation);
      * alloc-fail: report a page allocation that the pool could satisfy as
        failed (stalls, evictions, admission back-off);
      * restore-delay: defer a queued victim-pool restore by a step;
      * refcount-corrupt: bump a live page's refcount, require `audit()` to
        detect it, roll it back;
      * nan-logits: poison one occupied slot's logits with NaN (only that
        request retires, `status="poisoned"`);
      * bitflip-spilled-page: flip one byte of a spilled page in host
        memory (the restore's checksum must catch it and recompute the
        request from its prompt; needs `integrity` to be detected);
      * crash-at-step: raise `CrashInjected` at the start of step s, after
        the snapshot of step s - 1 (recovery through
        `Scheduler.restore()`).

    `*_steps` fire at exact 1-based scheduler steps; `*_rate` also fire
    from the `RandomState(seed)` stream, drawn on every query.  `start()`
    returns the per-run mutable state; a plan is reusable."""

    seed: int = 0
    evict_steps: Tuple[int, ...] = ()
    alloc_fail_steps: Tuple[int, ...] = ()
    restore_delay_steps: Tuple[int, ...] = ()
    corrupt_refcount_steps: Tuple[int, ...] = ()
    nan_logit_steps: Tuple[int, ...] = ()
    bitflip_spilled_page_steps: Tuple[int, ...] = ()
    crash_at_step: int = 0        # 0 = never; fires exactly once
    evict_rate: float = 0.0
    alloc_fail_rate: float = 0.0
    restore_delay_rate: float = 0.0
    max_faults: int = 1_000_000   # cap, so that rate-driven chaos ends

    def start(self) -> "FaultState":
        return FaultState(self)


class CrashInjected(RuntimeError):
    """The crash-at-step fault: a process crash at a chosen step."""


class FaultState:
    """Per-run mutable half of a `FaultPlan`: its rng stream and the count
    of faults fired by kind."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._rng = np.random.RandomState(plan.seed)
        self.fired: Dict[str, int] = {"evict": 0, "alloc_fail": 0,
                                      "restore_delay": 0, "corrupt": 0,
                                      "nan": 0, "bitflip": 0, "crash": 0}

    def _fire(self, kind: str, step: int, steps, rate: float) -> bool:
        hit = step in steps
        if rate > 0.0 and not hit:
            # a draw on every query: the stream position is a function of
            # the scheduler's (deterministic) sequence of queries
            hit = bool(self._rng.random_sample() < rate)
        if hit and sum(self.fired.values()) >= self.plan.max_faults:
            return False
        if hit:
            self.fired[kind] += 1
        return hit

    def force_evict(self, step: int) -> bool:
        return self._fire("evict", step, self.plan.evict_steps,
                          self.plan.evict_rate)

    def fail_alloc(self, step: int) -> bool:
        return self._fire("alloc_fail", step, self.plan.alloc_fail_steps,
                          self.plan.alloc_fail_rate)

    def delay_restore(self, step: int) -> bool:
        return self._fire("restore_delay", step,
                          self.plan.restore_delay_steps,
                          self.plan.restore_delay_rate)

    def corrupt_refcount(self, step: int) -> bool:
        return self._fire("corrupt", step, self.plan.corrupt_refcount_steps,
                          0.0)

    def poison_nan(self, step: int) -> bool:
        return self._fire("nan", step, self.plan.nan_logit_steps, 0.0)

    def bitflip_spilled_page(self, step: int) -> bool:
        return self._fire("bitflip", step,
                          self.plan.bitflip_spilled_page_steps, 0.0)

    def should_crash(self, step: int) -> bool:
        # exact step, fires once, no rng draw
        if (self.plan.crash_at_step and step == self.plan.crash_at_step
                and self.fired["crash"] == 0):
            self.fired["crash"] += 1
            return True
        return False


@dataclasses.dataclass
class StepWatchdog:
    """Rolling-median step timer: a step longer than `slo_factor` x the
    median of the last `window` steps (once 4 are known) is a straggler,
    counted and passed to `on_straggler(step, seconds, median)`."""

    slo_factor: float = 3.0
    window: int = 16
    clock: Callable[[], float] = time.monotonic
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    _durations: List[float] = dataclasses.field(default_factory=list)
    _t0: Optional[float] = None
    stragglers: int = 0

    def start(self):
        self._t0 = self.clock()

    def stop(self, step: int) -> bool:
        """True if this step breached the straggler SLO."""
        assert self._t0 is not None, "start() not called"
        dt = self.clock() - self._t0
        self._t0 = None
        is_straggler = False
        if len(self._durations) >= 4:
            med = float(np.median(self._durations[-self.window:]))
            if dt > self.slo_factor * med:
                is_straggler = True
                self.stragglers += 1
                if self.on_straggler:
                    self.on_straggler(step, dt, med)
        self._durations.append(dt)
        return is_straggler

    @property
    def median(self) -> float:
        return float(np.median(self._durations)) if self._durations else 0.0


def run_restartable(
    total_steps: int,
    make_state: Callable[[], Any],
    step_fn: Callable[[Any, int], Tuple[Any, Dict[str, Any]]],
    ckpt_dir: str,
    checkpoint_every: int = 10,
    keep: int = 3,
    watchdog: Optional[StepWatchdog] = None,
    max_restarts: int = 10,
) -> Tuple[Any, Dict[str, Any]]:
    """Run `step_fn(state, step)` up to `total_steps`, saving a checkpoint
    generation after every `checkpoint_every`-th step and the last.  A run
    starts from the newest intact generation in `ckpt_dir` where there is
    one; an exception in a step restores it (or a fresh `make_state()`)
    and goes on, up to `max_restarts` times."""
    state = make_state()
    restored, start = ckpt.restore_latest(ckpt_dir, state)
    if restored is not None:
        state, start = restored, start + 1
    else:
        start = 0
    restarts = 0
    metrics: Dict[str, Any] = {}
    step = start
    while step < total_steps:
        try:
            if watchdog:
                watchdog.start()
            state, metrics = step_fn(state, step)
            if watchdog:
                watchdog.stop(step)
            if (step + 1) % checkpoint_every == 0 or step + 1 == total_steps:
                ckpt.save(ckpt_dir, step, state, keep=keep)
            step += 1
        except KeyboardInterrupt:
            raise
        except Exception as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            print(f"[fault] step {step} failed ({e!r}); "
                  f"restoring latest checkpoint (restart {restarts})")
            restored, last = ckpt.restore_latest(ckpt_dir, state)
            if restored is None:
                state, step = make_state(), 0
            else:
                state, step = restored, last + 1
    return state, metrics
