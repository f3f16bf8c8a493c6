"""Deterministic fault injection for the serving Scheduler.

Counterpart of the JAX package's `runtime/fault.py` (`FaultPlan`,
`CrashInjected`, `FaultState`): a plan fires from the same
`numpy.random.RandomState(seed)` stream, in the same query order and under
the same `max_faults` cap, so one plan fires at the same scheduler queries
in both packages.  Neither `crash_at_step` nor `bitflip_spilled_page_steps`
draws from the stream, so a plan with or without them fires its rate
faults at the same queries.  The watchdog, elastic meshes and restartable
training are ROADMAP.md §1 item 9.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


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
