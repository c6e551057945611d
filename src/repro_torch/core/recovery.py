# fmt: off
# A copy of src/repro/core/recovery.py, kept in its hand-aligned layout so the
# two stay diffable line for line; only the imports name repro_torch.
"""Failure semantics for the online scheduling runtime.

JITA-4DS promises "continuous provisioning and re-provisioning" under
dynamically changing conditions; until now the online runtime only
re-planned *unplaced* work on :meth:`repro.core.online.OnlineDriver.repool`
— a PE dying mid-task silently kept its placed history as if the task had
finished. This module is the decision half of the recovery path (kept pure
for property testing; the state surgery lives in
:meth:`repro.core.schedulers.OnlineEngine.invalidate` and
:meth:`repro.core.online.OnlineDriver.fail`):

  * the **failure model** — at time ``t`` a set of PEs dies, a set of
    directed location links drops its in-flight transfers, or a PE is
    convicted as a transient straggler (no work loss — it is rotated out
    via the ordinary ``repool`` path);
  * **output lineage** (:func:`compute_lost`) — which placed tasks must be
    recomputed, Spark-style: work lost on dead PEs plus completed tasks
    whose only live output copy sat on a dead PE;
  * **retry budgeting** (:class:`RetryState`) — per-task attempt counts
    with exponential backoff on the resubmission arrival floor; tasks over
    budget condemn their whole instance (the driver cancels it);
  * **flap damping** (:class:`PEBackoff`) — a PE that keeps dying is
    quarantined for exponentially growing windows before it may rejoin.

Lineage model
-------------
A placed task's output lives on the PE that computed it, plus on every PE
whose task *consumed* it before the failure (inputs arrive by exec start
``start + comm_wait``; the consumer then holds a copy — the shuffle-fetch
copy of Spark's recompute model). ``compute_lost`` takes the least
fixpoint of three monotone rules over the placement record:

  1. *lost work*: a task on a dead PE whose ``finish > t`` (in flight, or
     scheduled into the future) is lost;
  2. *lost outputs*: a task whose output is still **needed** — some
     successor is unplaced (and not cancelled), placed but not yet
     executing by ``t`` (it has not fetched its inputs), or itself lost —
     and whose every copy-holder is dead or lost, is lost (recompute);
  3. *lost inputs*: a task whose execution had not started by ``t``
     (``exec_start > t``) — or that sits on a dead PE itself — and whose
     predecessor is lost, is lost too (the first never received its
     inputs; the second keeps the surviving record *pred-closed* when a
     completed-but-unneeded ghost's producer must be recomputed for a
     third consumer).

The fixpoint guarantees the *surviving* record replays cleanly — it is
pred-closed: a surviving task on a live PE with ``exec_start <= t``
cannot have a lost predecessor (it holds a live copy of every input), a
survivor with ``exec_start > t`` or on a dead PE cascades via rule 3 —
which is exactly the precondition :meth:`OnlineEngine.replay` needs (see
tests/test_chaos.py for the property check that found the ghost corner).
"""

from __future__ import annotations

import dataclasses
from typing import (AbstractSet, Callable, Dict, Iterable, List, Mapping,
                    Sequence, Tuple)

__all__ = [
    "TaskRecord", "compute_lost", "RetryState", "PEBackoff",
    "RecoveryReport", "PartitionReport",
]


@dataclasses.dataclass(frozen=True)
class TaskRecord:
    """Placement-record view of one placed task (from an
    :class:`repro.core.schedulers.Assignment`: ``exec_start`` is
    ``start + comm_wait`` — when its inputs had all arrived)."""

    pe: str
    start: float
    exec_start: float
    finish: float


def compute_lost(records: Mapping[str, TaskRecord],
                 succs_of: Callable[[str], Iterable[str]],
                 preds_of: Callable[[str], Iterable[str]],
                 dead_pes: AbstractSet[str], t: float,
                 extra_lost: AbstractSet[str] = frozenset(),
                 cancelled: AbstractSet[str] = frozenset()) -> List[str]:
    """Least fixpoint of the lineage rules (module docstring) over the
    placement record.

    ``records`` maps placed task name → :class:`TaskRecord`;
    ``succs_of``/``preds_of`` give DAG adjacency by name (successors may
    include unplaced tasks — any name absent from ``records``).
    ``extra_lost`` seeds additional invalidations (tasks whose in-flight
    input transfers rode a dead link — the caller computes link usage from
    its transfer plans). ``cancelled`` names unplaced tasks that will
    never run; they do not keep a producer's output "needed".

    Returns the lost task names in ``records`` iteration order
    (deterministic given an ordered mapping).
    """
    lost = {nm for nm in extra_lost if nm in records}
    for nm, r in records.items():  # det: ok records order is the documented return-order contract
        if r.pe in dead_pes and r.finish > t:
            lost.add(nm)
    changed = True
    while changed:
        changed = False
        for nm, r in records.items():  # det: ok fixpoint over a placement-ordered mapping
            if nm in lost:
                continue
            # rule 3: inputs never arrived
            if r.exec_start > t and any(p in lost for p in preds_of(nm)):
                lost.add(nm)
                changed = True
                continue
            # rule 2: output needed but every copy is on a dead/lost holder
            needed = False
            for s in succs_of(nm):
                if s in lost:
                    needed = True
                    break
                sr = records.get(s)
                if sr is None:
                    if s not in cancelled:
                        needed = True
                        break
                elif sr.exec_start > t:
                    # placed but not yet executing: it has not fetched its
                    # inputs, so it still needs the producer's output
                    needed = True
                    break
            if not needed:
                continue
            if r.pe not in dead_pes:
                continue  # the producer's own copy survives
            has_copy = False
            for s in succs_of(nm):
                sr = records.get(s)
                if (sr is not None and s not in lost
                        and sr.exec_start <= t and sr.pe not in dead_pes):
                    has_copy = True
                    break
            if not has_copy:
                lost.add(nm)
                changed = True
    out = [nm for nm in records if nm in lost]
    from repro_torch.core import sanitize
    if sanitize.enabled():
        # self-check: the fixpoint must be sound and closed (no survivor
        # violates a rule, no task was invalidated without justification)
        sanitize.check_lost_closure(records, out, succs_of, preds_of,
                                    dead_pes, t, extra_lost=set(extra_lost),
                                    cancelled=set(cancelled))
    return out


class RetryState:
    """Per-task retry budget + exponential backoff for resubmission.

    Each time a task is invalidated, :meth:`charge` bumps its attempt
    count. Within budget, the task's resubmission arrival floor is
    ``t + backoff_base * 2**(attempts - 1)`` (``t`` itself when the base
    is 0 — recomputation can never be scheduled before the failure it
    recovers from). Over budget, the task is *exhausted*: the driver
    cancels its whole instance rather than thrash on a doomed subgraph.
    """

    def __init__(self, budget: int = 3, backoff_base: float = 0.0) -> None:
        if budget < 1:
            raise ValueError("retry budget must be >= 1")
        self.budget = budget
        self.backoff_base = float(backoff_base)
        self.attempts: Dict[str, int] = {}

    def charge(self, names: Iterable[str], t: float
               ) -> Tuple[Dict[str, float], List[str]]:
        """Account one failed attempt per name at time ``t``. Returns
        ``(arrival floors for the resubmitted tasks, exhausted names)``."""
        floors: Dict[str, float] = {}
        exhausted: List[str] = []
        base = self.backoff_base
        for nm in names:
            k = self.attempts.get(nm, 0) + 1
            self.attempts[nm] = k
            if k > self.budget:
                exhausted.append(nm)
            else:
                floors[nm] = t + base * (2.0 ** (k - 1)) if base else t
        return floors, exhausted


class PEBackoff:
    """Exponential quarantine against flapping PEs.

    The ``k``-th recorded death of a PE quarantines it until
    ``t + base * 2**(k-1)`` (capped at ``max_window``); a rejoin attempt
    inside the window is refused by
    :meth:`repro.core.online.OnlineDriver.rejoin`.
    """

    def __init__(self, base: float = 30.0,
                 max_window: float = 3600.0) -> None:
        self.base = float(base)
        self.max_window = float(max_window)
        self.deaths: Dict[str, int] = {}
        self._until: Dict[str, float] = {}

    def record_failure(self, pe: str, t: float) -> float:
        """Record a death at ``t``; returns the quarantine deadline."""
        k = self.deaths.get(pe, 0) + 1
        self.deaths[pe] = k
        window = min(self.base * (2.0 ** (k - 1)), self.max_window)
        until = float(t) + window
        self._until[pe] = until
        return until

    def quarantined(self, pe: str, t: float) -> bool:
        return float(t) < self._until.get(pe, float("-inf"))

    def rejoin_at(self, pe: str) -> float:
        """Earliest time the PE may rejoin (-inf if never failed)."""
        return self._until.get(pe, float("-inf"))


@dataclasses.dataclass
class RecoveryReport:
    """Durable record of one :meth:`OnlineDriver.fail` event — together
    with the surviving assignment history and pending submissions this is
    everything :func:`repro.core.online.restart_from_history` needs to
    rebuild an equivalent driver (the recovery differential pinned in
    tests/test_recovery.py)."""

    t: float
    dead_pes: Tuple[str, ...]
    dead_links: Tuple[Tuple[str, str], ...]
    #: invalidated task names, in placement-record order
    lost: Tuple[str, ...]
    #: surviving history length (placed tasks kept)
    survivors: int
    #: task name -> resubmission arrival floor (retry backoff applied)
    retry_floors: Dict[str, float]
    #: instance names cancelled because a task exhausted its retry budget
    cancelled: Tuple[str, ...]
    #: pending (unadmitted) instance names shed under capacity loss
    shed: Tuple[str, ...]
    #: invalidated work, in execution-seconds (lost-work accounting)
    lost_exec_seconds: float
    #: wall-clock cost of the fail() call itself (recovery latency)
    wall_seconds: float = 0.0


@dataclasses.dataclass
class PartitionReport:
    """Durable record of one :meth:`OnlineDriver.partition` event (a WAN
    cut isolating a site — no work is lost; cross-partition work is
    *deferred* by horizon floors until the site's quarantine deadline).

    The matching :meth:`OnlineDriver.heal` either restores the floors
    (site back within its quarantine window — outputs trusted, nothing
    recomputed) or, past the window, escalates to the lost-work path.
    """

    t: float
    site: str
    #: quarantine deadline = the heal estimate priced into the floors
    #: (PEBackoff at site granularity: repeat partitions back off
    #: exponentially)
    deadline: float
    #: sites unreachable from the federation home while this cut holds
    unreachable: Tuple[str, ...]
    #: PE names whose ``pe_free`` horizon was raised to the deadline
    floored_pes: Tuple[str, ...]
    #: directed link keys whose ``link_free`` horizon was raised
    floored_links: Tuple[Tuple[str, str], ...]
    #: pending instance names deferred to the deadline (time-shifted
    #: arrival — their value-curve floors recompute at the new arrival)
    deferred: Tuple[str, ...]
    #: pending instance names shed (lowest value first, within the
    #: deferred set when one exists)
    shed: Tuple[str, ...]


def lost_exec_seconds(records: Mapping[str, TaskRecord],
                      lost: Sequence[str], t: float) -> float:
    """Execution-seconds of invalidated work actually burnt by time ``t``:
    completed lost tasks charge their full run, in-flight ones the part
    already executed (``t - exec_start``); work scheduled after ``t``
    never ran and charges nothing."""
    s = 0.0
    for nm in lost:
        r = records[nm]
        end = r.finish if r.finish <= t else t
        if end > r.exec_start:
            s += end - r.exec_start
    return s
