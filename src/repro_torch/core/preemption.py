# fmt: off
# A copy of src/repro/core/preemption.py, kept in its hand-aligned layout so the
# two stay diffable line for line; only the imports name repro_torch.
"""Value-aware preemption: checkpoint-and-displace running work.

The paper's elasticity story is *just-in-time* resource management: the
VDC serving a live workload mix must be able to hand resources to the
work that is worth the most right now. Admission-time deferral (the
online driver's floor-ordered gate) covers arrivals competing with
*pending* work — but until this module, a running low-value task could
never be displaced: ``repool`` only re-plans unplaced work, so a burst
of high-value arrivals had to queue behind whatever was already booked.

:meth:`repro.core.online.OnlineDriver.admit_preempting` closes that gap
using the machinery that already exists:

* **Victim selection** (:func:`find_victim`, pure): the in-flight
  placement at ``t`` whose *remaining value* — its instance curve
  evaluated at its booked finish — is lowest, provided the arrival's
  current curve value exceeds it by more than ``margin``.
* **Checkpoint pricing** (:class:`CheckpointCost`): displacing a task
  is not free. The victim's in-flight state is written out like a
  :class:`repro.train.checkpoint.CheckpointManager` commit — a
  bytes/bandwidth stream plus a fixed manifest/commit overhead — and
  must be restored before the task can run again. The write occupies
  the victim's PE via a durable ``"raise"`` horizon event (the PR-7
  partition mechanism), and the restore is priced into the victim's
  resubmission arrival floor.
* **Displacement** rides the PR-6 lineage machinery:
  :func:`repro.core.recovery.compute_lost` with the victim as
  ``extra_lost`` (no dead PEs) invalidates exactly the victim and the
  booked work that depended on it, and the floors re-enter through the
  admission gate — a *priced resubmission*, not a lost-work event: no
  retry budget is charged and no lost-work telemetry is recorded.
* **Audit trail** (:class:`PreemptionReport`): one frozen record per
  preempting admission, in the style of
  :class:`repro.train.fault_tolerance.RecoveryLog` — enough to explain
  every displacement decision after the fact.

Continuing a driver after a preemption stays byte-identical to
``restart_from_history`` on the durable record (history + retry floors
+ horizon events) — the same differential that pins ``fail()`` and the
site-granularity events, extended in tests/test_online.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

from repro_torch.core.dag import Task
from repro_torch.core.schedulers import Assignment
from repro_torch.core.vos import ValueCurve


@dataclasses.dataclass(frozen=True)
class CheckpointCost:
    """Cost model for checkpointing a preempted task's in-flight state.

    Mirrors the semantics of :mod:`repro.train.checkpoint`: a checkpoint
    is a streamed write of the state bytes plus a fixed
    manifest-and-commit overhead (the atomic COMMITTED marker), and a
    restore is the same stream read back. State size defaults to the
    task's ``out_bytes`` — the output being materialised is the state
    worth persisting — so a task with no recorded output still pays the
    commit overhead, never less.
    """

    #: checkpoint write stream, bytes/second
    write_bandwidth: float = 1.0e9
    #: restore read stream, bytes/second (reads are typically faster —
    #: no atomic-commit fsync on the read path)
    restore_bandwidth: float = 2.0e9
    #: fixed per-checkpoint cost (manifest + atomic commit marker)
    commit_overhead_s: float = 0.05

    def state_bytes(self, task: Task) -> float:
        return task.out_bytes if task.out_bytes > 0 else 0.0

    def checkpoint_seconds(self, task: Task) -> float:
        """PE-occupancy cost of writing the victim's checkpoint."""
        return self.commit_overhead_s + self.state_bytes(task) / self.write_bandwidth

    def restore_seconds(self, task: Task) -> float:
        """Delay before the displaced task may start executing again."""
        return self.commit_overhead_s + self.state_bytes(task) / self.restore_bandwidth


def find_victim(assignments: Sequence[Assignment], t: float,
                curve_of: Callable[[str], Optional[ValueCurve]],
                arrival_value: float,
                margin: float = 0.0) -> Optional[Assignment]:
    """The in-flight placement at ``t`` most worth displacing, or None.

    A placement is *in-flight* while ``start <= t < finish`` (its PE is
    booked right now — input staging counts: vacating the booking frees
    the machine either way). Its remaining value is its instance curve
    evaluated at its booked finish: what completing it is still worth.
    Only placements whose remaining value is strictly below
    ``arrival_value - margin`` qualify — preempting sideways or upwards
    would burn checkpoint time for nothing. Deterministic: the minimum
    of ``(remaining value, finish, task name)`` over the placement
    record, so equal-value victims tie-break on earliest finish then
    name. Tasks without a resolvable curve (no structured SLO) are never
    victims.
    """
    best: Optional[Assignment] = None
    best_key: Optional[Tuple[float, float, str]] = None
    threshold = arrival_value - margin
    for a in assignments:
        if not (a.start <= t < a.finish):
            continue
        c = curve_of(a.task)
        if c is None:
            continue
        v = c.value(a.finish)
        if v >= threshold:
            continue
        key = (v, a.finish, a.task)
        if best_key is None or key < best_key:
            best_key = key
            best = a
    return best


@dataclasses.dataclass(frozen=True)
class PreemptionReport:
    """Audit record of one preempting admission (see module docstring).

    ``victim is None`` means the arrival found nothing worth displacing
    and fell through to the normal admission gate (``submit``) — the
    preemption-disabled behaviour, so a driver that only ever takes that
    branch schedules byte-identically to one that never called
    ``admit_preempting`` at all."""

    t: float
    #: arriving instance name and its curve value at ``t``
    arrival: str
    arrival_value: float
    #: displaced task (None: no preemption happened)
    victim: Optional[str]
    victim_pe: Optional[str]
    #: victim's remaining value (curve at its booked finish) at decision
    victim_value: float
    #: full displaced closure (victim + booked dependents), placement order
    displaced: Tuple[str, ...]
    #: checkpoint write (PE occupancy) and restore (resubmission delay)
    checkpoint_seconds: float
    restore_seconds: float
    #: arrival floor the victim re-enters admission at (t + ckpt + restore)
    resume_floor: float
    wall_seconds: float
