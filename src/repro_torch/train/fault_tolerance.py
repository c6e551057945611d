# fmt: off
# A copy of src/repro/train/fault_tolerance.py, kept in its hand-aligned layout so the
# two stay diffable line for line; only the imports name repro_torch.
"""Failure injection, restart-from-checkpoint, straggler mitigation.

The decision logic (repro.core.elastic) is pure; this module wires it into
the training loop:

  * :class:`FailureInjector` — deterministic (seeded) schedule of worker
    failures and slowdowns, so fault-tolerance paths are *testable*;
  * :class:`RecoveryPolicy` — what to do on each event:
      - worker death  → drop worker, ``plan_remesh`` → shrink data axis,
        restore the latest committed checkpoint onto the new mesh (or
        reshard live state when the optimizer state survives);
      - straggler     → exclude + backup dispatch (re-mesh without the slow
        worker; at real scale this is the backup-task pattern);
      - rejoin        → grow the data axis back at the next boundary.
  * :class:`RecoveryLog` — auditable record of every event → action,
    asserted on by the integration tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.elastic import ElasticPlan, HealthMonitor, plan_remesh


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    step: int
    worker: str
    kind: str            # "die" | "slow" | "rejoin" | "partition" | "heal"
    factor: float = 1.0  # slowdown multiplier for "slow"


class FailureInjector:
    """Deterministic failure schedule (seeded) or explicit event list."""

    def __init__(self, events: Optional[Sequence[FailureEvent]] = None, *,
                 workers: Optional[Sequence[str]] = None,
                 p_fail: float = 0.0, p_slow: float = 0.0,
                 n_steps: int = 0, seed: int = 0) -> None:
        if events is None:
            events = []
            rng = np.random.default_rng(seed)
            for step in range(n_steps):
                for w in workers or []:
                    r = rng.random()
                    if r < p_fail:
                        events.append(FailureEvent(step, w, "die"))
                    elif r < p_fail + p_slow:
                        events.append(FailureEvent(step, w, "slow",
                                                   factor=float(rng.uniform(2, 5))))
        self._by_step: Dict[int, List[FailureEvent]] = {}
        for e in events:
            self._by_step.setdefault(e.step, []).append(e)

    def at(self, step: int) -> List[FailureEvent]:
        """Events due at ``step`` — consumed on read. A restart rewinds the
        step counter past the event's step (replaying from the checkpoint),
        and a node only dies once; non-consumed events would re-fire on the
        replayed steps forever."""
        return self._by_step.pop(step, [])


@dataclasses.dataclass
class RecoveryAction:
    step: int
    event: FailureEvent
    action: str                      # "restart_from_checkpoint" | "remesh" | ...
    plan: Optional[ElasticPlan] = None
    restored_step: Optional[int] = None


class RecoveryLog:
    def __init__(self) -> None:
        self.actions: List[RecoveryAction] = []

    def record(self, action: RecoveryAction) -> None:
        self.actions.append(action)

    def by_kind(self, kind: str) -> List[RecoveryAction]:
        return [a for a in self.actions if a.event.kind == kind]


class RecoveryPolicy:
    """Maps failure events to elastic actions for the Trainer.

    ``workers`` are simulated hosts; each owns ``devices_per_worker``
    devices of the data axis. The model axis is never broken (elastic
    invariant — see repro.core.elastic.plan_remesh).
    """

    def __init__(self, workers: Sequence[str], devices_per_worker: int,
                 model_axis: int, monitor: Optional[HealthMonitor] = None
                 ) -> None:
        self.workers = list(workers)
        self.devices_per_worker = devices_per_worker
        self.model_axis = model_axis
        self.monitor = monitor or HealthMonitor(workers)
        self.slow: Dict[str, float] = {}
        self.log = RecoveryLog()

    @property
    def healthy_workers(self) -> List[str]:
        return self.monitor.healthy()

    def healthy_devices(self) -> int:
        return len(self.healthy_workers) * self.devices_per_worker

    def handle(self, step: int, event: FailureEvent,
               current_data_axis: int) -> RecoveryAction:
        if event.kind == "die":
            self.monitor.mark_dead(event.worker)
            plan = plan_remesh(self.healthy_devices(), self.model_axis,
                               current_data_axis, allow_grow=False)
            act = RecoveryAction(step, event, "restart_from_checkpoint", plan)
        elif event.kind == "slow":
            self.slow[event.worker] = event.factor
            act = RecoveryAction(step, event, "monitor")
        elif event.kind == "rejoin":
            # proper rejoin: clears stale strikes and restarts the EWMA so
            # the worker is not re-convicted from pre-exclusion state
            self.monitor.mark_alive(event.worker)
            self.slow.pop(event.worker, None)
            plan = plan_remesh(self.healthy_devices(), self.model_axis,
                               current_data_axis, allow_grow=True)
            act = RecoveryAction(step, event, "remesh_grow", plan)
        else:
            raise ValueError(event.kind)
        self.log.record(act)
        return act

    def check_stragglers(self, step: int, step_times: Dict[str, float],
                         now: float, current_data_axis: int
                         ) -> Optional[RecoveryAction]:
        """Feed per-worker step times; if the monitor convicts a straggler,
        plan a re-mesh that excludes it (backup-dispatch pattern)."""
        for w, t in sorted(step_times.items()):
            if self.monitor.health[w].alive:
                self.monitor.observe(w, t * self.slow.get(w, 1.0), now)
        convicted = self.monitor.stragglers()
        if not convicted:
            return None
        w = convicted[0]
        self.monitor.mark_dead(w)   # excluded (can rejoin later)
        plan = plan_remesh(self.healthy_devices(), self.model_axis,
                           current_data_axis, allow_grow=False)
        act = RecoveryAction(step, FailureEvent(step, w, "slow"),
                             "exclude_straggler", plan)
        self.log.record(act)
        return act
