# fmt: off
# A copy of src/repro/core/sanitize.py, kept in its hand-aligned layout so the
# two stay diffable line for line; only the imports name repro_torch.
"""Runtime schedule sanitizer — the simulated-resource analogue of TSan/ASan.

Every correctness pin in this repo is a byte-identical-schedule claim, and
the digests only say two runs *agree* — not that either run respects the
resource model. This module re-derives the structural invariants of the
engine's timing model with an independent (deliberately simple, O(n log n))
algorithm and raises a typed :class:`SanitizerError` the moment a schedule
or an online step violates one:

* **dependency** — no task starts before every placed predecessor finished,
  and its inputs (predecessor pulls + the raw-input upload for source tasks
  off the data home) have landed by ``start + comm_wait``;
* **PE double-booking** — per PE, the ``[start, finish]`` hold intervals of
  distinct tasks never overlap;
* **link overlap** — per directed ``(src_loc, dst_loc)`` link, the FIFO
  serialization of every transfer re-derived from the DAG reproduces the
  recorded ``comm_wait`` (a race detector for the contended WAN);
* **monotone horizons** — ``pe_free`` / ``link_free`` never decrease except
  through the documented rejoin/heal paths (``apply_horizon_event
  ("restore")``, ``repool``, ``invalidate``);
* **lineage** — the lost set computed at a failure is sound and closed
  under the recovery rules, and ghost-pin re-home overrides resolve to
  locations that still exist while some consumer needs them;
* **ValueCurve non-increase** — a curve handed to the VoS policy never
  gains value with a later finish.

Enable with ``REPRO_SANITIZE=1`` in the environment (the chaos and golden
suites run under it in CI) or explicitly via ``sanitize=True`` on
:func:`repro.core.simulator.run_instances` /
:class:`repro.core.online.OnlineDriver`. Off, the only cost is a ``None``
check per driver event; on, each online step costs O(log n) plus a small
constant, and each full :func:`validate_schedule` pass is O(n log n).
"""

from __future__ import annotations

import bisect
import math
import os
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Set, Tuple)

__all__ = [
    "SanitizerError", "DependencyViolation", "DoubleBooking", "LinkOverlap",
    "HorizonMonotonicityError", "LineageError", "CurveError",
    "enabled", "tolerance", "validate_curve", "validate_pool",
    "validate_schedule", "check_lost_closure", "check_execution_report",
    "ScheduleSanitizer",
]

ENV_FLAG = "REPRO_SANITIZE"


class SanitizerError(AssertionError):
    """Base class: a structural invariant of the resource model failed."""


class DependencyViolation(SanitizerError):
    """A task started before a predecessor's output (or its own raw input)
    could exist at its location."""


class DoubleBooking(SanitizerError):
    """Two tasks hold the same PE over overlapping intervals."""


class LinkOverlap(SanitizerError):
    """A directed link's recorded transfer serialization is inconsistent
    with FIFO booking — two transfers raced for the same channel."""


class HorizonMonotonicityError(SanitizerError):
    """A ``pe_free``/``link_free`` horizon moved backwards outside the
    documented restore/repool/invalidate paths."""


class LineageError(SanitizerError):
    """The failure-recovery lost set is unsound/unclosed, or a ghost-pin
    override points at a location that no longer exists while a consumer
    still needs the output."""


class CurveError(SanitizerError):
    """A value-of-service curve increases with finish time."""


def enabled(flag: Optional[bool] = None) -> bool:
    """Explicit ``flag`` wins; ``None`` defers to ``REPRO_SANITIZE``."""
    if flag is not None:
        return bool(flag)
    return os.environ.get(ENV_FLAG, "") not in ("", "0")


def tolerance(*xs: float) -> float:
    """Absolute comparison slack for times around magnitude ``max(xs)``.

    The engine's times are produced by max/add chains over plain floats;
    re-deriving them walks the same chain in a different association, so
    equality holds only to a few ulps."""
    m = 1.0
    for x in xs:
        ax = abs(x)
        if ax > m:
            m = ax
    return 1e-9 * m


# ---------------------------------------------------------------------------
# value curves
# ---------------------------------------------------------------------------

def validate_curve(curve, name: str = "") -> None:
    """Sample ``curve.value`` and require it non-increasing and finite.

    Works for any object with a ``value(finish) -> float`` method (the
    engine's duck-typed curve contract), not just
    :class:`repro.core.vos.ValueCurve` — this is the check that catches a
    hand-rolled curve whose constructor never validated anything."""
    xs: List[float] = [0.0]
    breaks = tuple(getattr(curve, "breaks", ()) or ())
    for b in breaks:
        xs.extend((b - 1e-9, b, b + 1e-9, b * 0.5))
    last = breaks[-1] if breaks else 1.0
    xs.extend((last + 1.0, last * 2.0 + 1.0, last * 10.0 + 1.0))
    xs = sorted(x for x in xs if x >= 0.0)
    prev_x = prev_v = None
    for x in xs:
        v = curve.value(x)
        if not math.isfinite(v):
            raise CurveError(f"curve {name or curve!r}: value({x}) = {v}")
        if prev_v is not None and v > prev_v + tolerance(prev_v, v):
            raise CurveError(
                f"curve {name or curve!r} increases: value({prev_x}) = "
                f"{prev_v} < value({x}) = {v}")
        prev_x, prev_v = x, v


# ---------------------------------------------------------------------------
# pools
# ---------------------------------------------------------------------------

def validate_pool(pool) -> None:
    """Structural pool invariants (unique PE names, positive speeds, sane
    links) as a typed :class:`SanitizerError`. Delegates to
    :meth:`repro.core.resources.ResourcePool.validate`."""
    try:
        pool.validate()
    except ValueError as e:
        raise SanitizerError(str(e)) from None


# ---------------------------------------------------------------------------
# full-schedule validation (batch engine / clean online runs)
# ---------------------------------------------------------------------------

def validate_schedule(sched, dag=None, cost=None,
                      arrival: Optional[Mapping[str, float]] = None, *,
                      index=None, contended_links: bool = True,
                      curves: Optional[Mapping] = None,
                      check_links: bool = True) -> None:
    """Validate an emitted :class:`repro.core.schedulers.Schedule` against
    its DAG, pool and cost model.

    This is the *clean-run* checker: every assignment's PE must be in the
    schedule's pool and each task placed exactly once (post-failure
    histories with ghost placements are checked incrementally by
    :class:`ScheduleSanitizer` instead). Checks, in order: placement
    uniqueness, arrival floors, predecessor ordering and finish-before-
    start, per-PE interval overlap, and (``check_links``) an independent
    FIFO re-derivation of every transfer that must reproduce the recorded
    ``comm_wait`` on pain of :class:`LinkOverlap`."""
    di = index if index is not None else dag.index()
    pool = sched.pool
    validate_pool(pool)
    pi = pool.index()
    idx_of = pi.idx_of
    pe_location = pi.pe_location
    id_of = di.id_of
    names = di.names
    tasks = di.tasks
    arrival = arrival or {}
    if curves:
        for inst, c in sorted(curves.items()):
            validate_curve(c, name=str(inst))

    assignments = sched.assignments
    order: Dict[str, int] = {}
    for i, a in enumerate(assignments):
        if a.task in order:
            raise DependencyViolation(
                f"task {a.task!r} placed twice (#{order[a.task]} and #{i})")
        if a.task not in id_of:
            raise DependencyViolation(f"unknown task {a.task!r} in schedule")
        if a.pe not in idx_of:
            raise DoubleBooking(
                f"task {a.task!r} placed on {a.pe!r}, not in the pool")
        if a.comm_wait < -tolerance(a.comm_wait):
            raise DependencyViolation(
                f"task {a.task!r} has negative comm_wait {a.comm_wait}")
        if a.finish + tolerance(a.finish, a.start) < a.start + a.comm_wait:
            raise DependencyViolation(
                f"task {a.task!r} finishes at {a.finish}, before its inputs "
                f"arrive at {a.start + a.comm_wait}")
        floor = arrival.get(a.task, 0.0)
        if a.start + tolerance(a.start, floor) < floor:
            raise DependencyViolation(
                f"task {a.task!r} starts at {a.start}, before its arrival "
                f"floor {floor}")
        order[a.task] = i

    # dependency: every predecessor placed, placed earlier, finished by start
    for a in assignments:
        tid = id_of[a.task]
        for p in di.preds[tid]:
            pn = names[p]
            j = order.get(pn)
            if j is None:
                raise DependencyViolation(
                    f"task {a.task!r} placed but predecessor {pn!r} is not")
            if j > order[a.task]:
                raise DependencyViolation(
                    f"task {a.task!r} placed (#{order[a.task]}) before its "
                    f"predecessor {pn!r} (#{j})")
            pf = assignments[j].finish
            if a.start + tolerance(a.start, pf) < pf:
                raise DependencyViolation(
                    f"task {a.task!r} starts at {a.start} < predecessor "
                    f"{pn!r} finish {pf}")

    # PE intervals: the PE is held from start (dispatch) to finish
    by_pe: Dict[str, List[Tuple[float, float, str]]] = {}
    for a in assignments:
        by_pe.setdefault(a.pe, []).append((a.start, a.finish, a.task))
    for pe, ivs in sorted(by_pe.items()):
        ivs.sort()
        for (s0, f0, t0), (s1, f1, t1) in zip(ivs, ivs[1:],
                                                strict=False):
            if s1 + tolerance(s1, f0) < f0:
                raise DoubleBooking(
                    f"PE {pe!r} double-booked: {t0!r} holds [{s0}, {f0}] "
                    f"and {t1!r} holds [{s1}, {f1}]")

    if not check_links or cost is None:
        return

    # transfers: re-book every plan FIFO in placement order and require the
    # recorded comm_wait to match the re-derived input-arrival time
    transfer_time = pool.transfer_time
    home = getattr(cost, "data_home", None)
    shadow_free: Dict[Tuple[str, str], float] = {}
    loc_of_task: Dict[str, str] = {}
    for a in assignments:
        tid = id_of[a.task]
        loc = pe_location[idx_of[a.pe]]
        hold = a.start
        t = hold
        plan: List[Tuple[Tuple[str, str], float]] = []
        task = tasks[tid]
        if home is not None and task.in_bytes > 0 and loc != home:
            plan.append(((home, loc), transfer_time(home, loc,
                                                    task.in_bytes)))
        for p in di.preds[tid]:
            src = loc_of_task[names[p]]
            ob = tasks[p].out_bytes
            if ob > 0 and src != loc:
                plan.append(((src, loc), transfer_time(src, loc, ob)))
        if contended_links:
            for key, dur in plan:
                s = shadow_free.get(key, 0.0)
                if s < hold:
                    s = hold
                arrive = s + dur
                shadow_free[key] = arrive
                if arrive > t:
                    t = arrive
        else:
            for _key, dur in plan:
                arrive = hold + dur
                if arrive > t:
                    t = arrive
        got = a.start + a.comm_wait
        if abs(got - t) > tolerance(got, t):
            raise LinkOverlap(
                f"task {a.task!r} on {a.pe!r}: recorded exec start {got} "
                f"but FIFO re-booking of its transfers gives {t} — a link "
                f"was double-booked or a transfer was never charged")
        loc_of_task[a.task] = loc


# ---------------------------------------------------------------------------
# lineage (failure recovery)
# ---------------------------------------------------------------------------

def check_lost_closure(records: Mapping, lost: Iterable[str],
                       succs_of: Callable[[str], Iterable[str]],
                       preds_of: Callable[[str], Iterable[str]],
                       dead_pes: Set[str], t: float,
                       extra_lost: Set[str] = frozenset(),
                       cancelled: Set[str] = frozenset()) -> None:
    """Re-verify a :func:`repro.core.recovery.compute_lost` result.

    *Closure*: no survivor violates rule 1 (unfinished on a dead PE),
    rule 3 (not yet executing with a lost predecessor) or rule 2 (output
    still needed, producer's PE dead, no surviving executed consumer holds
    a copy). *Soundness*: every lost task is justified by a rule or by the
    ``extra_lost`` seed — the recovery path never throws away work it
    could have kept."""
    lost_set = set(lost)

    def needed(nm: str) -> bool:
        for s in succs_of(nm):
            if s in lost_set:
                return True
            sr = records.get(s)
            if sr is None:
                if s not in cancelled:
                    return True
            elif sr.exec_start > t:
                return True
        return False

    def has_copy(nm: str) -> bool:
        for s in succs_of(nm):
            sr = records.get(s)
            if (sr is not None and s not in lost_set
                    and sr.exec_start <= t and sr.pe not in dead_pes):
                return True
        return False

    for nm in sorted(records):
        r = records[nm]
        if nm in lost_set:
            if nm in extra_lost:
                continue
            if r.pe in dead_pes and r.finish > t:
                continue  # rule 1
            if r.exec_start > t and any(p in lost_set
                                        for p in preds_of(nm)):
                continue  # rule 3
            if needed(nm) and r.pe in dead_pes and not has_copy(nm):
                continue  # rule 2
            raise LineageError(
                f"task {nm!r} invalidated without justification "
                f"(pe={r.pe!r}, finish={r.finish}, t={t})")
        if r.pe in dead_pes and r.finish > t:
            raise LineageError(
                f"task {nm!r} survived rule 1: unfinished on dead PE "
                f"{r.pe!r} (finish {r.finish} > t {t})")
        if r.exec_start > t and any(p in lost_set for p in preds_of(nm)):
            raise LineageError(
                f"task {nm!r} survived rule 3: not yet executing at {t} "
                f"with an invalidated predecessor")
        if needed(nm) and r.pe in dead_pes and not has_copy(nm):
            raise LineageError(
                f"task {nm!r} survived rule 2: output still needed, PE "
                f"{r.pe!r} dead, and no live executed consumer holds a copy")


# ---------------------------------------------------------------------------
# execution reports
# ---------------------------------------------------------------------------

def check_execution_report(report, dag) -> None:
    """Post-execution invariants for :class:`repro.core.executor`
    reports: every produced output has at least one live copy-holder, and
    every executed task's predecessors executed (or were resumed) first."""
    dead = set(report.dead)
    for nm in sorted(report.outputs):
        holders = set(report.copies.get(nm, ())) - dead
        if not holders:
            raise LineageError(
                f"output {nm!r} reported live but every copy-holder died")
    ran_at: Dict[str, int] = {r.task: i for i, r in enumerate(report.runs)}
    lost = set(report.lost)
    preds = dag.predecessors
    for r in report.runs:
        for p in preds(r.task):
            if p.name in ran_at:
                if ran_at[p.name] > ran_at[r.task]:
                    raise DependencyViolation(
                        f"task {r.task!r} executed before its predecessor "
                        f"{p.name!r}")
            elif p.name not in report.outputs and p.name not in lost:
                raise DependencyViolation(
                    f"task {r.task!r} executed but predecessor {p.name!r} "
                    f"neither ran nor was resumed")


# ---------------------------------------------------------------------------
# online sanitizer
# ---------------------------------------------------------------------------

class ScheduleSanitizer:
    """Stepwise invariant checker attached to an online driver.

    Keeps shadow copies of the horizon state plus per-PE interval sets for
    the *current incarnation* of every pooled PE (a dead PE's intervals
    are dropped with it — a same-named rejoin starts a new incarnation at
    a fresh horizon, so the old ghost intervals are not that PE's
    bookings). The engine's own incremental structures are never trusted:
    every check re-derives from the assignment stream and the DAG.

    Driver integration points (all no-ops when sanitizing is off):
    ``after_step`` on every placement, ``on_horizon_event`` from
    partition/heal, ``check_fail`` inside ``fail()`` between the lineage
    pass and the engine invalidate, ``resync`` after every documented
    horizon-lowering path (restore/repool/invalidate/rejoin)."""

    def __init__(self, driver) -> None:
        self.driver = driver
        self.events_checked = 0
        self._intervals: Dict[str, List[Tuple[float, float]]] = {}
        self._shadow_pe: Dict[str, float] = {}
        self._shadow_link: Dict[Tuple[str, str], float] = {}
        #: True once the pool changed mid-run (elastic repool/rejoin) — the
        #: final whole-schedule pass only holds for single-pool histories
        self.saw_repool = False
        self.resync("init")

    # -- shadow maintenance ------------------------------------------------

    def resync(self, why: str) -> None:
        """Re-baseline the shadow horizons from the engine after one of
        the documented horizon-lowering paths (``why`` is for error
        messages only). Interval sets for PEs that left the pool are
        dropped; lost placements must be removed via :meth:`drop_tasks`
        by the failure path before its invalidate replays survivors."""
        if why == "repool":
            self.saw_repool = True
        eng = self.driver.eng
        pi = eng._pi
        self._shadow_pe = {p.name: eng._pe_free[j]
                           for j, p in enumerate(pi.pes)}
        self._shadow_link = dict(eng.link_free)
        pooled = set(self._shadow_pe)
        self._intervals = {pe: iv for pe, iv in self._intervals.items()  # det: ok check-only shadow; order never escapes
                           if pe in pooled}

    def drop_tasks(self, lost: Iterable[str]) -> None:
        """Remove invalidated tasks' hold intervals (their resubmission
        may legitimately reuse the vacated window)."""
        lost_set = set(lost)
        if not lost_set:
            return
        eng = self.driver.eng
        starts: Dict[Tuple[str, float, float], str] = {}
        for a in eng.assignments:
            starts[(a.pe, a.start, a.finish)] = a.task
        for pe, iv in list(self._intervals.items()):  # det: ok check-only shadow; order never escapes
            kept = [sf for sf in iv
                    if starts.get((pe, sf[0], sf[1])) is not None
                    and starts[(pe, sf[0], sf[1])] not in lost_set]
            self._intervals[pe] = kept

    # -- per-event checks --------------------------------------------------

    def after_step(self, a) -> None:
        """Validate one live placement: arrival floor, dependency,
        double-booking against this incarnation's intervals, and horizon
        monotonicity since the previous event."""
        eng = self.driver.eng
        di = eng._di
        tid = di.id_of[a.task]
        self.events_checked += 1

        floor = eng._arr[tid]
        if a.start + tolerance(a.start, floor) < floor:
            raise DependencyViolation(
                f"online: task {a.task!r} starts at {a.start}, before its "
                f"arrival floor {floor}")
        if a.comm_wait < -tolerance(a.comm_wait):
            raise DependencyViolation(
                f"online: task {a.task!r} has negative comm_wait "
                f"{a.comm_wait}")
        fin = eng._finish
        for p in di.preds[tid]:
            pf = fin[p]
            if pf is None:
                raise DependencyViolation(
                    f"online: task {a.task!r} placed before predecessor "
                    f"{di.names[p]!r}")
            if a.start + tolerance(a.start, pf) < pf:
                raise DependencyViolation(
                    f"online: task {a.task!r} starts at {a.start} < "
                    f"predecessor {di.names[p]!r} finish {pf}")

        iv = self._intervals.setdefault(a.pe, [])
        pos = bisect.bisect_left(iv, (a.start, a.finish))
        if pos > 0:
            ps, pf = iv[pos - 1]
            if a.start + tolerance(a.start, pf) < pf:
                raise DoubleBooking(
                    f"online: task {a.task!r} holds {a.pe!r} over "
                    f"[{a.start}, {a.finish}], overlapping a booking "
                    f"ending at {pf}")
        if pos < len(iv):
            ns, _nf = iv[pos]
            if ns + tolerance(ns, a.finish) < a.finish:
                raise DoubleBooking(
                    f"online: task {a.task!r} holds {a.pe!r} over "
                    f"[{a.start}, {a.finish}], overlapping a booking "
                    f"starting at {ns}")
        iv.insert(pos, (a.start, a.finish))

        self._check_monotone(f"after placing {a.task!r}")

    def _check_monotone(self, ctx: str) -> None:
        eng = self.driver.eng
        pi = eng._pi
        shadow = self._shadow_pe
        for j, p in enumerate(pi.pes):
            cur = eng._pe_free[j]
            prev = shadow.get(p.name)
            if prev is not None and cur + tolerance(cur, prev) < prev:
                raise HorizonMonotonicityError(
                    f"pe_free[{p.name!r}] moved backwards {prev} -> {cur} "
                    f"{ctx} (not a documented restore/repool path)")
            shadow[p.name] = cur
        slink = self._shadow_link
        for key, cur in eng.link_free.items():  # det: ok per-key compare; order-free
            prev = slink.get(key)
            if prev is not None and cur + tolerance(cur, prev) < prev:
                raise HorizonMonotonicityError(
                    f"link_free[{key}] moved backwards {prev} -> {cur} "
                    f"{ctx}")
            slink[key] = cur

    def on_horizon_event(self, kind: str, pe_map: Mapping,
                         link_map: Mapping) -> None:
        """Called after the driver applies a partition/heal horizon event.
        A ``raise`` must actually be monotone; a ``restore`` is a
        documented lowering path and re-baselines the shadows."""
        if kind == "raise":
            self._check_monotone("after horizon raise")
        else:
            self.resync(kind)

    def check_fail(self, records: Mapping, lost: Sequence[str],
                   succs_of, preds_of, dead_pes: Set[str], t: float,
                   extra_lost: Set[str] = frozenset(),
                   cancelled: Set[str] = frozenset()) -> None:
        """Inside ``fail()``: verify the lost set, then forget the lost
        intervals before the engine's invalidate replays survivors."""
        check_lost_closure(records, lost, succs_of, preds_of, dead_pes, t,
                           extra_lost=extra_lost, cancelled=cancelled)
        self.drop_tasks(lost)

    def check_overrides(self) -> None:
        """Ghost-pin re-home overrides (task-name keys in the driver's
        ``loc_of``) must stay *routable* while an un-executed consumer
        will fetch from them: the location either hosts live PEs (a
        consumer placed there fetches intra-location) or appears as a
        source in the pool's link matrix. A location with no live PEs is
        fine — outputs live at locations, not PEs — but one with no
        outbound route either would KeyError the engine's transfer
        pricing the moment the consumer is placed elsewhere."""
        drv = self.driver
        eng = drv.eng
        di = eng._di
        id_of = di.id_of
        fin = eng._finish
        routable = {p.location for p in drv.pool.pes}
        routable.update(src for src, _dst in drv.pool._links)
        for nm in sorted(drv._loc_of):
            tid = id_of.get(nm)
            if tid is None:
                continue  # PE-name entry, not a task override
            loc = drv._loc_of[nm]
            if loc in routable:
                continue
            for s in di.succs[tid]:
                if fin[s] is None and s not in eng._cancelled:
                    raise LineageError(
                        f"ghost-pin override for {nm!r} points at "
                        f"unroutable location {loc!r} but consumer "
                        f"{di.names[s]!r} still needs its output")

    # -- end-of-run --------------------------------------------------------

    def validate_final(self) -> None:
        """Full-schedule validation of a *clean* run (no failures, no
        horizon events): the stepwise checks already covered each event,
        this closes the loop with the independent whole-schedule pass."""
        drv = self.driver
        if (self.saw_repool or drv.recoveries or drv.horizon_events
                or drv.cancelled_instances
                or self.events_checked != len(drv.eng.assignments)):
            # not a fully-observed clean run: replayed history (restart
            # drivers), failures, partitions, or an elastic pool change —
            # the stepwise checks already covered what they could see
            return
        eng = drv.eng
        di = eng._di
        arrival = {di.names[i]: t for i, t in enumerate(eng._arr) if t > 0.0}
        validate_schedule(drv.schedule(), cost=drv.cost, arrival=arrival,
                          index=di, contended_links=eng.contended_links)
