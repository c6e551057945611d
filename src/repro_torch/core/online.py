# fmt: off
# A copy of src/repro/core/online.py, kept in its hand-aligned layout so the
# two stay diffable line for line; only the imports name repro_torch.
"""Streaming workload driver — the paper's *online* workload manager.

The paper's runtime is online: pipeline instances "arrive" over time, the
workload manager dispatches their tasks as resources free up, and the VDC
is "dynamically and automatically assembled and re-assembled". The batch
path (:func:`repro.core.simulator.run_instances` with ``period > 0``)
emulates this by materialising the full arrival map up front and solving
one merged problem; this module feeds instances into a *live*
:class:`repro.core.schedulers.OnlineEngine` as they arrive and retires
finished ones — the same schedules, produced by an actual runtime loop
whose per-event cost is independent of how many instances the run will
ever see.

Admission gate (why deferred admission is exact)
------------------------------------------------
Every policy key the engine uses leads with a time-like component that is
bounded below by a per-instance *arrival floor* (EFT/Min-Min: finish ≥
arrival; Hwang ETF: hold; ETF: ready_at itself; VoS:
``-curve.value(t)``, since each instance's value curve is non-increasing —
also as computed in floats). The driver keeps pending instances in a heap
ordered by ``(floor, arrival, submit order)``; while

    ``min pending floor > policy.peek_time()``

no task of *any* pending instance can win — or even tie — the next
placement, and the driver may defer all of them. Floor order (not arrival
order) matters once floors are heterogeneous: with per-instance VoS curves
a later-arriving high-value instance can have a *lower* floor than an
earlier low-value one, and must be admitted first. For every other policy
the floor is the arrival time itself, so the heap degenerates to arrival
order and the behaviour is unchanged. The gate re-checks after every
admission (fresh candidates can only lower the best key, pulling more
instances in); when it stops admitting, the candidate set visible to the
selector contains every candidate that could possibly be chosen, so each
pop equals the batch engine's pop by induction. RR and HEFT have no
time-keyed selection (``deferrable = False``): reproducing their batch
schedules requires full foreknowledge, and the driver admits every
pending instance (in arrival order) before placing (documented
degeneration — those policies are inherently offline).

Elastic re-plan
---------------
:meth:`OnlineDriver.repool` applies a grown/shrunk pool to the live run:
the engine remaps horizons by PE name, drops cached transfer plans and
link horizons for vanished locations, rebuilds cost tables, re-marks the
ready set, and the policy run rebinds its selector over the survivors —
in-flight schedules adapt without a full restart. The dual
:func:`restart_from_history` path rebuilds an equivalent driver from the
durable record (admissions + assignment history) on the surviving pool;
tests/test_online.py differentially pins the two against each other.

Typical use::

    drv = OnlineDriver(paper_pool(), CostModel(), policy="eft")
    for i in range(1000):
        drv.submit(workload.instance(i), arrival_t=i * period)
    schedule = drv.run()          # or: while drv.step() is not None: ...
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.cost_model import CostModel
from repro_torch.core.dag import PipelineDAG
from repro_torch.core.preemption import (CheckpointCost, PreemptionReport,
                                   find_victim)
from repro_torch.core.recovery import (PartitionReport, PEBackoff, RecoveryReport,
                                 RetryState, TaskRecord, compute_lost,
                                 lost_exec_seconds)
from repro_torch.core.resources import ResourcePool
from repro_torch.core.sanitize import ScheduleSanitizer
from repro_torch.core.sanitize import enabled as _sanitize_enabled
from repro_torch.core.sanitize import validate_curve as _validate_curve
from repro_torch.core import vos as vos_mod
from repro_torch.core.schedulers import (Assignment, OnlineEngine, Schedule,
                                   make_policy_run)
from repro_torch.core.simulator import RunResult


@dataclasses.dataclass
class InstanceState:
    """Book-keeping for one admitted pipeline instance."""

    name: str
    arrival: float
    first_tid: int
    n_tasks: int
    dag: PipelineDAG
    remaining: int = 0
    finish: float = 0.0
    completed: bool = False
    #: withdrawn after a task exhausted its retry budget (never completes)
    cancelled: bool = False


@dataclasses.dataclass
class OnlineRunResult(RunResult):
    """Batch-compatible result plus online-run telemetry."""

    #: placements performed (= tasks admitted when the run drains)
    n_events: int = 0
    #: high-water mark of simultaneously live (admitted, unfinished)
    #: instances — the quantity per-event cost actually scales with
    max_live: int = 0
    #: (instance name, completion time) in completion order
    completions: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)
    #: failure events recovered from (:meth:`OnlineDriver.fail` calls)
    n_failures: int = 0
    #: placed tasks invalidated across all failures (lineage recompute)
    n_lost_tasks: int = 0
    #: execution-seconds of invalidated work actually burnt
    lost_exec_seconds: float = 0.0
    #: instance names cancelled (retry budget) or shed (capacity loss)
    cancelled: List[str] = dataclasses.field(default_factory=list)
    shed: List[str] = dataclasses.field(default_factory=list)
    #: preempting admissions that actually displaced work
    #: (:meth:`OnlineDriver.admit_preempting` with a victim)
    n_preemptions: int = 0
    #: booked tasks displaced across all preemptions (victim + booked
    #: dependents, re-entering as priced resubmissions)
    n_displaced: int = 0
    #: admission sweeps that admitted more than one instance against a
    #: single gate peek (``OnlineEngine.admit_batch`` fast path)
    n_batched_steps: int = 0


class OnlineDriver:
    """Event loop gluing pending arrivals, the live engine and one policy.

    ``submit`` queues an instance for arrival at ``arrival_t`` (any order;
    a heap keeps them sorted, ties broken by submission order — the same
    order the batch path merges instances in). ``step`` admits every
    instance the admission gate says could influence the next placement,
    then places exactly one task. ``run`` drains pending + live work and
    returns the :class:`Schedule`.

    Finished instances are *retired*: their completion is recorded and
    their per-task transfer-plan cache rows are freed, so live memory in
    the hot structures tracks the live set, not everything ever admitted.
    """

    def __init__(self, pool: ResourcePool, cost: Optional[CostModel] = None,
                 policy: str = "eft", contended_links: bool = True,
                 sanitize: Optional[bool] = None, **policy_kw) -> None:
        #: site topology, when constructed over a
        #: :class:`repro.core.federation.FederatedPool` — the engine always
        #: sees the flattened pool; the federation only informs the
        #: site-granularity event surface (partition/heal/fail_site)
        self.federation = None
        if hasattr(pool, "flatten"):
            self.federation = pool
            pool = pool.flatten()
        self.pool = pool
        self.cost = cost or CostModel()
        self.policy_name = policy
        self.eng = OnlineEngine(pool, self.cost,
                                contended_links=contended_links)
        self.policy = make_policy_run(policy, self.eng, **policy_kw)
        #: pending submissions in (arrival, submit order) — the durable
        #: record order
        self._pending: List[Tuple[float, int, PipelineDAG]] = []
        #: gate view of the pending set, ordered by the policy's
        #: per-instance arrival floor (built lazily; floors may need policy
        #: state that only exists after the first admission, and are
        #: invalidated by repool — pool-derived VoS defaults re-derive)
        self._gate: Optional[List[Tuple[float, float, int, PipelineDAG]]] = None
        #: lazy-deletion marks, one set per heap the stale entry can still
        #: sit in: an instance admitted from the gate leaves its (t, seq,
        #: dag) tuple in _pending (drained by _drain_pending), one admitted
        #: in arrival order leaves its floor entry in _gate (skipped by the
        #: gate loop). Seqs are dropped as the stale entries are popped, so
        #: driver memory tracks the live pending set, not total submissions
        self._dead_pending: set = set()
        self._dead_gate: set = set()
        self._n_pending = 0
        self._seq = 0
        self.instances: List[InstanceState] = []
        self._inst_of: List[int] = []  # tid -> index into self.instances
        self.completions: List[Tuple[str, float]] = []
        self.n_events = 0
        self.max_live = 0
        self._live = 0
        # -- failure semantics (see repro.core.recovery) ---------------------
        #: per-task retry budget/backoff — replace before the first failure
        #: to tune (e.g. ``drv.retry = RetryState(budget=5, backoff_base=2)``)
        self.retry = RetryState()
        #: flap quarantine against PEs that keep dying
        self.pe_backoff = PEBackoff()
        #: PE name -> location, for every PE ever pooled — lets survivors
        #: placed on since-dead PEs replay (their outputs stay at the
        #: location; see OnlineEngine.replay)
        self._loc_of: Dict[str, str] = {p.name: p.location for p in pool.pes}
        #: durable recovery record: one report per fail() event, cumulative
        #: max-merged resubmission floors, cancelled/shed instance names —
        #: with the surviving history this is what restart_from_history
        #: needs to rebuild an equivalent driver after failures
        self.recoveries: List[RecoveryReport] = []
        self.retry_floors: Dict[str, float] = {}
        self.cancelled_instances: List[str] = []
        self.shed_instances: List[str] = []
        # -- value-aware preemption (see repro.core.preemption) --------------
        #: audit record, one report per admit_preempting() call
        self.preemptions: List[PreemptionReport] = []
        #: preempting admissions that displaced work / tasks displaced
        self.n_preemptions = 0
        self.n_displaced = 0
        #: admission sweeps that admitted >1 instance in one engine batch
        self.n_batched_steps = 0
        # -- site-level fault domains (see repro.core.federation) ------------
        #: flap quarantine at *site* granularity — a partition's quarantine
        #: deadline doubles as the heal estimate priced into the floors
        self.site_backoff = PEBackoff()
        #: durable horizon-event log: (history index, kind, pe_map,
        #: link_map) — with the surviving history this replays the exact
        #: partition floors (see OnlineEngine.replay_with_horizons); fail()
        #: re-indexes it against the surviving record
        self.horizon_events: List[Tuple[int, str, dict, dict]] = []
        #: partition reports, one per partition() event
        self.partitions: List[PartitionReport] = []
        #: WAN pairs currently cut (frozenset site pairs) / sites down
        self._cut: set = set()
        self._down_sites: set = set()
        #: live partitions: site -> saved pre-raise horizons for heal
        self._partition_saved: Dict[str, dict] = {}
        #: pending instances deferred by a partition: name -> original
        #: arrival (heal re-times them to max(original, heal time))
        self._deferred_arrivals: Dict[str, float] = {}
        #: opt-in runtime invariant checker (``sanitize=True`` or
        #: ``REPRO_SANITIZE=1``) — validates every placement and every
        #: recovery event against :mod:`repro.core.sanitize`
        self.sanitizer: Optional[ScheduleSanitizer] = (
            ScheduleSanitizer(self) if _sanitize_enabled(sanitize) else None)

    # -- submission / admission ----------------------------------------------
    def submit(self, dag: PipelineDAG, arrival_t: float = 0.0,
               curve=None) -> None:
        """Queue ``dag`` to arrive at ``arrival_t`` (not yet admitted).

        ``curve`` attaches a per-instance SLO
        (:class:`repro.core.vos.ValueCurve`) for the VoS policy — the
        streaming counterpart of ``schedule_vos(curves=...)``; the curve is
        registered before admission so the admission gate's floor is exact
        for this instance."""
        arrival_t = float(arrival_t)
        if curve is not None:
            add = getattr(self.policy, "add_curve", None)
            if add is None:
                raise ValueError(
                    f"submit(curve=...) needs the 'vos' policy, not "
                    f"{self.policy_name!r}")
            add(dag, curve)
        if curve is not None and self.sanitizer is not None:
            _validate_curve(curve, name=dag.name)
        heapq.heappush(self._pending, (arrival_t, self._seq, dag))
        if self._gate is not None:
            heapq.heappush(self._gate,
                           (self.policy.arrival_floor(arrival_t, dag),
                            arrival_t, self._seq, dag))
        self._seq += 1
        self._n_pending += 1

    @property
    def pending(self) -> int:
        return self._n_pending

    def pending_submissions(self) -> List[Tuple[PipelineDAG, float]]:
        """Live (dag, arrival) submissions in (arrival, submit) order —
        the not-yet-admitted half of the durable record
        :func:`restart_from_history` consumes. For the VoS policy the
        record additionally includes :meth:`slo_curves` (per-instance
        curves are policy state, not derivable from the DAGs)."""
        live = [(t, seq, dag) for (t, seq, dag) in self._pending
                if seq not in self._dead_pending]
        live.sort(key=lambda e: (e[0], e[1]))
        return [(dag, t) for (t, _seq, dag) in live]

    def slo_curves(self) -> dict:
        """Snapshot of the per-instance VoS curve map (instance id →
        :class:`repro.core.vos.ValueCurve`; empty for other policies) —
        the curve half of the durable record: pass it as ``curves=`` to
        :func:`restart_from_history` so a rebuilt driver schedules under
        the same SLOs."""
        return dict(getattr(self.policy, "curves", ()) or {})

    def backlog(self, t: float) -> Tuple[float, float]:
        """``(mean, max)`` booked-ahead seconds over the pool's PEs at
        time ``t`` — how far the engine's committed plan runs past "now".
        The serving gateway's overload signal (:mod:`repro.serve.gateway`):
        shedding and preemption trigger on it rather than on queue length,
        because the planner books admitted work into the future instantly,
        so the schedule horizon — not the pending count — is what measures
        load."""
        pe_free = self.eng._pe_free
        if not len(pe_free):
            return (0.0, 0.0)
        ahead = [max(0.0, float(f) - t) for f in pe_free]
        return (sum(ahead) / len(ahead), max(ahead))

    @property
    def live_instances(self) -> int:
        return self._live

    def _admit_now(self, dag: PipelineDAG, arrival_t: float) -> InstanceState:
        self._admit_now_batch([(dag, arrival_t)])
        return self.instances[-1]

    def _admit_now_batch(self,
                         batch: Sequence[Tuple[PipelineDAG, float]]) -> None:
        """Admit ``k`` instances in one engine call
        (:meth:`OnlineEngine.admit_batch`): dense per-task state grows
        once, the cost tables grow by one concatenated batch call, and the
        selector re-advertises the whole batch's sources in one
        ``push_ready`` sweep on the next step. Per-instance policy state
        (``on_admit``) and instance book-keeping still run in admission
        order — byte-identical to k sequential :meth:`_admit_now` calls
        (``on_admit`` folds ranks/curves from the DAG and pool only, never
        from interleaved engine state)."""
        tid_lists = self.eng.admit_batch([dag for dag, _t in batch],
                                         [t for _dag, t in batch])
        on_admit = self.policy.on_admit
        instances = self.instances
        for (dag, arrival_t), tids in zip(batch, tid_lists, strict=True):
            on_admit(dag)
            inst = InstanceState(dag.name, arrival_t,
                                 tids[0] if tids else len(self._inst_of),
                                 len(tids), dag, remaining=len(tids))
            instances.append(inst)
            self._inst_of.extend([len(instances) - 1] * len(tids))
            if inst.remaining == 0:  # degenerate empty instance
                inst.completed = True
                self.completions.append((inst.name, inst.finish))
            else:
                self._live += 1
                if self._live > self.max_live:
                    self.max_live = self._live
        if len(batch) > 1:
            self.n_batched_steps += 1

    def _drain_pending(self) -> None:
        """Lazily pop _pending entries the floor gate already admitted
        (their seqs are then fully retired)."""
        pending = self._pending
        dead = self._dead_pending
        while pending and pending[0][1] in dead:
            dead.discard(heapq.heappop(pending)[1])

    def _pop_earliest(self) -> Tuple[float, int, PipelineDAG]:
        """Pop the live pending entry with the earliest (arrival, submit)
        key."""
        self._drain_pending()
        return heapq.heappop(self._pending)

    def _admit_due(self) -> None:
        """Admit every pending instance whose per-instance key floor does
        not exceed the current best candidate key (see module docstring).
        Admissions are *batched*: each sweep drains the whole
        ``floor <= best`` prefix of the gate heap against a single
        ``peek_time`` and folds it into the engine with one
        :meth:`_admit_now_batch` call, then re-peeks — fresh candidates
        may lower the best key and pull in further arrivals. A sweep can
        admit an instance a strictly serial gate would have held a peek
        or two longer (serial re-peeks between admissions, and the best
        key only decreases), but every such instance's candidate keys are
        >= its floor > the keys that win the interleaved pops, so the
        placement sequence — and the schedule — is byte-identical to
        serial admission (pinned by the batch-vs-serial differentials in
        tests/test_online.py)."""
        pol = self.policy
        eng = self.eng
        deferrable = pol.deferrable
        while self._n_pending:
            # only gate when live candidates exist: with an empty ready set
            # the next arrival (in arrival order) must be admitted
            # regardless (and policy state — e.g. VoS's default curve —
            # may not exist before the first admission)
            if not (deferrable and eng._ready):
                # non-deferrable policies take this branch for *every*
                # pending instance — drain them all as one batch, in
                # (arrival, submit) order
                batch: List[Tuple[PipelineDAG, float]] = []
                while self._n_pending:
                    t, seq, dag = self._pop_earliest()
                    if self._gate is not None:
                        self._dead_gate.add(seq)  # its floor entry lingers
                    self._n_pending -= 1
                    batch.append((dag, t))
                    if deferrable:
                        break  # first admission may create candidates
                self._admit_now_batch(batch)
                continue
            gate = self._gate
            if gate is None:
                gate = self._gate = []
                self._dead_gate.clear()
                dead = self._dead_pending
                for t, seq, dag in self._pending:
                    if seq not in dead:
                        heapq.heappush(gate,
                                       (pol.arrival_floor(t, dag), t, seq,
                                        dag))
            dead_gate = self._dead_gate
            while gate and gate[0][2] in dead_gate:
                dead_gate.discard(heapq.heappop(gate)[2])
            if not gate:
                break
            best = pol.peek_time()
            batch = []
            while gate:
                floor, t, seq, dag = gate[0]
                if best is not None and floor > best:
                    break
                heapq.heappop(gate)
                self._dead_pending.add(seq)
                self._n_pending -= 1
                batch.append((dag, t))
                while gate and gate[0][2] in dead_gate:
                    dead_gate.discard(heapq.heappop(gate)[2])
            if not batch:
                break
            self._drain_pending()
            self._admit_now_batch(batch)

    # -- value-aware preemption -----------------------------------------------
    def admit_preempting(self, dag: PipelineDAG, arrival_t: float,
                         curve: Optional[object] = None,
                         checkpoint: Optional[CheckpointCost] = None,
                         margin: float = 0.0) -> PreemptionReport:
        """Admit ``dag`` at ``arrival_t``, displacing running low-value
        work when the arrival is worth more (see
        :mod:`repro.core.preemption`).

        The arrival's worth is its curve value at ``arrival_t`` (the
        negated admission-gate floor). If some in-flight placement's
        remaining value sits more than ``margin`` below it, that victim
        is checkpointed and displaced: its PE is occupied for the
        checkpoint write via a durable ``"raise"`` horizon event, the
        victim (plus booked dependents, via the PR-6 lineage pass with
        the victim as ``extra_lost``) is invalidated, and the victim
        re-enters admission at ``t + checkpoint + restore`` — a *priced
        resubmission*: no retry budget charged, no lost-work telemetry.
        Otherwise this degrades to a plain :meth:`submit` through the
        admission gate and records a victimless report, so a run in
        which no preemption fires is byte-identical to one that never
        called this method. Needs the ``"vos"`` policy with structured
        curves (value comparison is curve-denominated).

        Continuing the driver afterwards stays byte-identical to
        :func:`restart_from_history` on the durable record — the same
        differential that pins :meth:`fail`."""
        t = float(arrival_t)
        t0 = time.perf_counter()
        pol = self.policy
        if not hasattr(pol, "add_curve") or getattr(pol, "_custom", False):
            raise ValueError(
                "admit_preempting needs the 'vos' policy with structured "
                f"value curves, not {self.policy_name!r}")
        if curve is not None:
            pol.add_curve(dag, curve)
            if self.sanitizer is not None:
                _validate_curve(curve, name=dag.name)
        arrival_value = -pol.arrival_floor(t, dag)
        eng = self.eng
        di = eng._di
        id_of = di.id_of
        names = di.names
        task_curves = pol._task_curves
        pool_default = pol._pool_default

        def curve_of(nm: str) -> Optional[object]:
            c = task_curves[id_of[nm]]
            return c if c is not None else pool_default[0]

        victim = None
        if arrival_value != float("inf"):
            victim = find_victim(eng.assignments, t, curve_of,
                                 arrival_value, margin)
        if victim is None:
            self.submit(dag, t)
            rep = PreemptionReport(
                t=t, arrival=dag.name, arrival_value=arrival_value,
                victim=None, victim_pe=None, victim_value=float("nan"),
                displaced=(), checkpoint_seconds=0.0, restore_seconds=0.0,
                resume_floor=t,
                wall_seconds=time.perf_counter() - t0)
            self.preemptions.append(rep)
            return rep
        victim_task = di.tasks[id_of[victim.task]]
        victim_curve = curve_of(victim.task)
        victim_value = victim_curve.value(victim.finish)
        ckpt = checkpoint if checkpoint is not None else CheckpointCost()
        ck_s = ckpt.checkpoint_seconds(victim_task)
        rs_s = ckpt.restore_seconds(victim_task)
        resume_floor = t + ck_s + rs_s
        # displaced closure: the victim plus every booked task that
        # (transitively) consumed its never-produced output — same
        # lineage pass as fail(), with no dead PEs
        records = {a.task: TaskRecord(a.pe, a.start, a.start + a.comm_wait,
                                      a.finish)
                   for a in eng.assignments}
        cancelled_names = {names[tid] for tid in eng._cancelled}

        def succs_of(nm: str) -> List[str]:
            return [names[s] for s in di.succs[id_of[nm]]]

        def preds_of(nm: str) -> List[str]:
            return [names[p] for p in di.preds[id_of[nm]]]

        lost = compute_lost(records, succs_of, preds_of, set(), t,
                            extra_lost={victim.task},
                            cancelled=cancelled_names)
        if self.sanitizer is not None:
            self.sanitizer.check_fail(records, lost, succs_of, preds_of,
                                      set(), t, extra_lost={victim.task},
                                      cancelled=cancelled_names)
        # priced resubmission, not a failure: no retry.charge, no
        # lost-work telemetry — but the resume floor is durable like any
        # backoff floor (restart_from_history re-applies it)
        floors = {victim.task: resume_floor}
        if resume_floor > self.retry_floors.get(victim.task, float("-inf")):
            self.retry_floors[victim.task] = resume_floor
        lost_names = set(lost)
        for nm in lost:
            self._loc_of.pop(nm, None)
        self.horizon_events = self._remap_horizon_events(eng.assignments,
                                                         lost_names)
        eng.invalidate([id_of[nm] for nm in lost], arrival_floors=floors,
                       loc_of=self._loc_of, events=self.horizon_events)
        fin = eng._finish
        for inst in self.instances:
            if inst.cancelled:
                eng.cancel([tid for tid in range(
                    inst.first_tid, inst.first_tid + inst.n_tasks)
                    if fin[tid] is None])
        self._resync_instances()
        if self.sanitizer is not None:
            self.sanitizer.resync("preempt")
        # the checkpoint write occupies the victim's PE until t + ck_s —
        # a durable horizon raise (replayed at this history index on
        # restart; also rebinds the policy and resets the gate)
        self._apply_event_live("raise", {victim.pe: t + ck_s}, {})
        self._admit_now(dag, t)
        self.n_preemptions += 1
        self.n_displaced += len(lost)
        rep = PreemptionReport(
            t=t, arrival=dag.name, arrival_value=arrival_value,
            victim=victim.task, victim_pe=victim.pe,
            victim_value=victim_value, displaced=tuple(lost),
            checkpoint_seconds=ck_s, restore_seconds=rs_s,
            resume_floor=resume_floor,
            wall_seconds=time.perf_counter() - t0)
        self.preemptions.append(rep)
        if self.sanitizer is not None:
            self.sanitizer.check_overrides()
        return rep

    # -- the event loop -------------------------------------------------------
    def step(self) -> Optional[Assignment]:
        """One event: admit due arrivals, place one task. None when no
        placeable work remains (drained, or only far-future arrivals that
        were all admitted — impossible — so: fully drained)."""
        if self._n_pending:
            self._admit_due()
        eng = self.eng
        if eng.done():
            return None
        tid = self.policy.step()
        self.n_events += 1
        a = eng.assignments[-1]
        if self.sanitizer is not None:
            self.sanitizer.after_step(a)
        inst = self.instances[self._inst_of[tid]]
        inst.remaining -= 1
        if a.finish > inst.finish:
            inst.finish = a.finish
        if inst.remaining == 0:
            inst.completed = True
            self._live -= 1
            self.completions.append((inst.name, inst.finish))
            self._retire(inst)
        return a

    def _retire(self, inst: InstanceState) -> None:
        # placed tasks' transfer plans are never consulted again — free the
        # cached tuples so plan-cache memory follows the live set
        for row in self.eng._plans.values():  # det: ok in-place row reset; order-free
            for tid in range(inst.first_tid, inst.first_tid + inst.n_tasks):
                row[tid] = None

    def run(self) -> Schedule:
        """Drain all pending arrivals and live work."""
        while True:
            if self.step() is None and not self._n_pending:
                break
        if self.sanitizer is not None:
            self.sanitizer.validate_final()
        return self.schedule()

    # -- elastic re-plan ------------------------------------------------------
    def repool(self, new_pool: ResourcePool) -> None:
        """Apply a grown/shrunk pool to the live run: engine state is
        remapped/re-keyed (:meth:`OnlineEngine.repool`) and the policy run
        rebinds its selector over the survivors. O(live ready set · |PE|)
        on the next step — independent of total instances admitted.

        Per-instance value curves survive untouched (they are
        pool-independent SLOs); only the gate's floor heap is rebuilt,
        because a pool-*derived* VoS default curve is re-derived from the
        survivors on rebind."""
        self.pool = new_pool
        for p in new_pool.pes:
            self._loc_of[p.name] = p.location
        self.eng.repool(new_pool)
        self.policy.rebind()
        self._gate = None
        if self.sanitizer is not None:
            self.sanitizer.resync("repool")

    # -- failure recovery -----------------------------------------------------
    def fail(self, t: float, pes: Sequence[str] = (),
             links: Sequence[Tuple[str, str]] = (),
             shed: object = 0, quarantine: bool = True,
             drop_links: bool = False) -> RecoveryReport:
        """Recover from a failure at time ``t``: the named PEs die and the
        named ``(src_loc, dst_loc)`` links drop their in-flight transfers
        (transient — the link itself recovers; its victims' inputs do not).

        Work completed on surviving PEs is kept. In-flight and future work
        on dead PEs is invalidated, as are completed tasks whose only live
        output copy sat on a dead PE (lineage recompute — see
        :func:`repro.core.recovery.compute_lost`) and tasks whose inputs
        rode a dead link mid-transfer. The lost subgraph is resubmitted
        with per-task retry budgets and exponential-backoff arrival floors
        (:class:`repro.core.recovery.RetryState`); a task over budget
        cancels its whole instance. ``shed`` pending instances are dropped
        lowest-value first (``shed="auto"``: proportional to the capacity
        lost). Dead PEs are quarantined against flapping rejoins
        (:class:`repro.core.recovery.PEBackoff`).

        ``quarantine=False`` skips the per-PE flap quarantine (used by the
        site-granularity paths, which quarantine at site level via
        :attr:`site_backoff` instead). ``drop_links=True`` removes the
        named links from the pool's matrix permanently (site loss tears
        down the site's WAN attachments; the default models a transient
        link drop whose victims lose only their in-flight transfers).

        After the call, continuing this driver is byte-identical to
        :func:`restart_from_history` on the surviving pool with the
        surviving history, cumulative ``retry_floors``, ``cancelled``
        instances and re-indexed ``horizon_events`` — the recovery
        differential, pinned for all 7 policies in tests/test_recovery.py
        and at site granularity in tests/test_chaos.py."""
        t = float(t)
        t0 = time.perf_counter()
        eng = self.eng
        di = eng._di
        id_of = di.id_of
        names = di.names
        dead = tuple(dict.fromkeys(pes))
        dead_set = set(dead)
        dead_links = tuple((str(s), str(d)) for s, d in links)
        if quarantine:
            for pe in dead:
                self.pe_backoff.record_failure(pe, t)
        # lineage pass over the placement record
        records = {a.task: TaskRecord(a.pe, a.start, a.start + a.comm_wait,
                                      a.finish)
                   for a in eng.assignments}
        victims = self._link_victims(t, set(dead_links))
        cancelled_names = {names[tid] for tid in eng._cancelled}
        lost = compute_lost(
            records,
            lambda nm: [names[s] for s in di.succs[id_of[nm]]],
            lambda nm: [names[p] for p in di.preds[id_of[nm]]],
            dead_set, t, extra_lost=victims, cancelled=cancelled_names)
        if self.sanitizer is not None:
            self.sanitizer.check_fail(
                records, lost,
                lambda nm: [names[s] for s in di.succs[id_of[nm]]],
                lambda nm: [names[p] for p in di.preds[id_of[nm]]],
                dead_set, t, extra_lost=victims, cancelled=cancelled_names)
        lost_secs = lost_exec_seconds(records, lost, t)
        lost_set = set(lost)
        # an invalidated task's output no longer exists anywhere: drop any
        # re-home override from an earlier site loss (recompute re-places)
        for nm in lost:
            self._loc_of.pop(nm, None)
        # Every survivor on a dead PE gets a task-name override in loc_of
        # (it outranks PE lookup during replay — see
        # SchedulerEngine.replay), which pins it to ghost replay: the dead
        # PE's bookings died with it, so if a same-named PE later rejoins
        # (at a fresh 0.0 horizon), neither a restart nor a later
        # invalidate may re-book the pre-death placements on it. The
        # override's location: normally the recorded location (the route
        # to it still exists); under drop_links (site loss) that location
        # is unroutable, so a survivor kept because an executed consumer
        # on a live PE holds a fetched copy (compute_lost's has_copy
        # rule) re-homes to the copy-holder's location, and one kept
        # because nothing needs its output anymore keeps the recorded
        # location (it is never fetched again).
        rehomed = False
        # drop_links fallback: a live-side location, so a re-homed
        # ghost's replayed input transfers stay off the torn-down WAN —
        # live booked nothing there (the route was gone at fail time),
        # and a restart after the links are re-created must not re-book
        # them on the fresh matrix either
        live_loc = next((p.location for p in self.pool.pes
                         if p.name not in dead_set), None)
        for nm, r in records.items():  # det: ok independent per-task re-home; records keep placement order
            if nm in lost_set or r.pe not in dead_set:
                continue
            # an earlier fail's override (task-name key) stays put unless
            # this one finds a better home
            loc = self._loc_of.get(nm, self._loc_of[r.pe])
            if drop_links:
                if live_loc is not None:
                    loc = live_loc
                for s in (names[x] for x in di.succs[id_of[nm]]):
                    sr = records.get(s)
                    if (sr is not None and s not in lost_set
                            and sr.exec_start <= t
                            and sr.pe not in dead_set):
                        loc = self._loc_of[sr.pe]
                        break
            self._loc_of[nm] = loc
            # repool preserves _placed_loc and invalidate may not run
            # (nothing lost) — push the re-home into the live engine
            # directly; replay recomputes the same value from loc_of
            eng._placed_loc[id_of[nm]] = loc
            rehomed = True
        if rehomed:
            eng._plans = {}  # cached plans priced the old location
        # retry accounting: charge every lost task one attempt
        floors, exhausted = self.retry.charge(lost, t)
        for nm, fl in floors.items():  # det: ok independent per-task max; order-free
            if fl > self.retry_floors.get(nm, float("-inf")):
                self.retry_floors[nm] = fl
        newly_cancelled: List[str] = []
        for nm in exhausted:
            inst = self.instances[self._inst_of[id_of[nm]]]
            if not inst.cancelled:
                inst.cancelled = True
                newly_cancelled.append(inst.name)
                self.cancelled_instances.append(inst.name)
        # shrink the pool, then rebuild live state around the survivors
        pool_names = {p.name for p in self.pool.pes}
        dead_in_pool = [p for p in dead if p in pool_names]
        dropped_links = [lk for lk in dead_links
                         if drop_links and lk in self.pool._links]
        n_before = len(self.pool.pes)
        if dead_in_pool or dropped_links:
            self.pool = self.pool.without(dead_in_pool)
            if dropped_links:
                self.pool = self.pool.without_links(dropped_links)
            eng.repool(self.pool)
            # scrub removed PEs / dropped links from the durable
            # horizon-event log: live, their entries are permanent no-ops
            # (apply skips absent names, and repool never re-applies them
            # after a rejoin re-admits same-named PEs at a fresh 0.0
            # baseline), so a restart must not replay them against the
            # final pool either. Entries for surviving PEs/links stay —
            # invalidate below re-applies those symmetrically.
            dead_pe_names = set(dead_in_pool)
            dropped_set = set(dropped_links)
            self.horizon_events = [
                ev for ev in (
                    (idx, kind,
                     {nm: v for nm, v in pe_map.items()  # det: ok filter keeps recorded event order
                      if nm not in dead_pe_names},
                     {lk: v for lk, v in link_map.items()  # det: ok filter keeps recorded event order
                      if lk not in dropped_set})
                    for idx, kind, pe_map, link_map in self.horizon_events)
                if ev[2] or ev[3]]
        if lost or newly_cancelled:
            # the horizon-event log indexes into the pre-failure history;
            # re-index it against the surviving record so invalidate's
            # segmented replay re-applies partition floors between the
            # same bookings they were applied between live
            lost_names = set(lost)
            self.horizon_events = self._remap_horizon_events(
                eng.assignments, lost_names)
            survivors = eng.invalidate([id_of[nm] for nm in lost],
                                       arrival_floors=floors,
                                       loc_of=self._loc_of,
                                       events=self.horizon_events)
            fin = eng._finish
            for inst in self.instances:
                if inst.cancelled:
                    eng.cancel([tid for tid in range(
                        inst.first_tid, inst.first_tid + inst.n_tasks)
                        if fin[tid] is None])
            self._resync_instances()
        else:
            survivors = eng.assignments
        if dead_in_pool or dropped_links or lost or newly_cancelled:
            # only rebind when engine state actually changed: repool and
            # invalidate both re-mark _newly for the fresh selector, but a
            # no-op failure (nothing lost, no pooled PE died) did neither —
            # rebinding then would strand the already-advertised ready set
            self.policy.rebind()
            self._gate = None
        if shed == "auto":
            k = (-(-self._n_pending * len(dead_in_pool) // n_before)
                 if dead_in_pool and n_before else 0)
        else:
            k = int(shed)  # type: ignore[call-overload]
        shed_names = [dag.name for dag, _t in self.shed_pending(k)]
        report = RecoveryReport(
            t=t, dead_pes=dead, dead_links=dead_links, lost=tuple(lost),
            survivors=len(survivors), retry_floors=floors,
            cancelled=tuple(newly_cancelled), shed=tuple(shed_names),
            lost_exec_seconds=lost_secs,
            wall_seconds=time.perf_counter() - t0)
        self.recoveries.append(report)
        if self.sanitizer is not None:
            self.sanitizer.resync("fail")
            self.sanitizer.check_overrides()
        return report

    def _link_victims(self, t: float, dead_links: set) -> set:
        """Placed tasks whose input transfers were mid-flight on a dead
        link at ``t`` (held but not yet executing, plan routes over the
        link) — they never receive their inputs and must re-plan."""
        if not dead_links:
            return set()
        eng = self.eng
        id_of = eng._di.id_of
        victims = set()
        for a in eng.assignments:
            if a.start <= t < a.start + a.comm_wait:
                tid = id_of[a.task]
                loc = eng._placed_loc[tid]
                try:
                    plan = eng._plan(tid, loc)
                except KeyError:
                    continue
                if any(lk in dead_links for lk, _d in plan):
                    victims.add(a.task)
        return victims

    def _resync_instances(self) -> None:
        """Rebuild instance book-keeping from the engine's finish array
        after an invalidation — un-retires instances whose placed work was
        lost, re-retires the still-complete ones, and rebuilds the
        completion record in (time, name) order (the order a restarted
        driver derives; retirement order is not in the durable record)."""
        finish = self.eng._finish
        self.completions = []
        live = 0
        for inst in self.instances:
            fins = [f for f in
                    finish[inst.first_tid:inst.first_tid + inst.n_tasks]
                    if f is not None]
            inst.finish = max(fins, default=0.0)
            if inst.cancelled:
                inst.remaining = 0
                inst.completed = False
                continue
            inst.remaining = inst.n_tasks - len(fins)
            inst.completed = inst.remaining == 0 and inst.n_tasks > 0
            if inst.n_tasks == 0:  # degenerate empty instance
                inst.completed = True
            if inst.completed:
                self.completions.append((inst.name, inst.finish))
                self._retire(inst)
            elif inst.n_tasks > 0:
                live += 1
        self.completions.sort(key=lambda c: (c[1], c[0]))
        self._live = live
        if live > self.max_live:
            self.max_live = live

    def shed_pending(self, k: int, within: Optional[Sequence[str]] = None
                     ) -> List[Tuple[PipelineDAG, float]]:
        """Shed the ``k`` pending (unadmitted) instances with the largest
        policy arrival floor — under VoS that is the lowest-value SLO
        curve; for every other policy the floor is the arrival time, so
        the latest arrivals go first. Graceful degradation under capacity
        loss: load is dropped before it can starve higher-value admitted
        work. ``within`` restricts shedding to the named instances
        (per-site shedding during a partition: only the deferred,
        far-side-bound set is eligible). Returns the shed (dag, arrival)
        pairs, first-shed first."""
        if k <= 0 or not self._n_pending:
            return []
        pol = self.policy
        live = [(t, seq, dag) for (t, seq, dag) in self._pending
                if seq not in self._dead_pending]
        if within is not None:
            want = set(within)
            live = [e for e in live if e[2].name in want]
        live.sort(key=lambda e: (pol.arrival_floor(e[0], e[2]), e[0], e[1]),
                  reverse=True)
        out: List[Tuple[PipelineDAG, float]] = []
        for t, seq, dag in live[:k]:
            self._dead_pending.add(seq)
            if self._gate is not None:
                self._dead_gate.add(seq)
            self._n_pending -= 1
            self.shed_instances.append(dag.name)
            out.append((dag, t))
        self._drain_pending()
        return out

    def rejoin(self, t: float, fragment: ResourcePool
               ) -> Tuple[List[str], List[str]]:
        """Re-admit returning PEs and/or links at time ``t``. ``fragment``
        carries the PEs and any links they bring; PEs still inside their
        flap quarantine window (:class:`repro.core.recovery.PEBackoff`)
        are refused. A fragment may also be *link-only* (no PEs — a WAN
        uplink healing on its own): links absent from the pool's matrix
        are re-admitted unconditionally, since quarantine is tracked per
        PE. Returns ``(accepted, refused)`` PE names; the pool grows (one
        repool) iff any PE was accepted or any new link arrived."""
        t = float(t)
        in_pool = {p.name for p in self.pool.pes}
        accepted: List[str] = []
        refused: List[str] = []
        for p in fragment.pes:
            if p.name in in_pool:
                continue
            if self.pe_backoff.quarantined(p.name, t):
                refused.append(p.name)
            else:
                accepted.append(p.name)
        new_links = [lk for lk in fragment._links
                     if lk not in self.pool._links]
        if accepted or new_links:
            keep = set(accepted)
            add = ResourcePool([p for p in fragment.pes if p.name in keep],
                               list(fragment._links.values()),
                               fragment.intra_location_bandwidth)
            self.repool(self.pool.union(add))
        return accepted, refused

    # -- site-level fault domains (WAN partitions, site loss) -----------------
    def _require_federation(self):
        fed = self.federation
        if fed is None:
            raise ValueError(
                "site-granularity events need a driver constructed over a "
                "FederatedPool (e.g. OnlineDriver(paper_federation(), ...))")
        return fed

    def _live_pending(self) -> List[Tuple[float, int, PipelineDAG]]:
        return [(t, seq, dag) for (t, seq, dag) in self._pending
                if seq not in self._dead_pending]

    def _retime_pending(self, new_t_of: Mapping[str, float]) -> List[str]:
        """Move pending (unadmitted) submissions to new arrival times.
        Gate floors are recomputed at the shifted arrival — a deferred
        instance re-enters admission at its *time-shifted* value floor
        (``-curve.value(new_t)``), not its submission-time floor. Returns
        the moved instance names."""
        if not new_t_of:
            return []
        moved: List[str] = []
        for t_arr, seq, dag in self._live_pending():
            t_new = new_t_of.get(dag.name)
            if t_new is None or float(t_new) == t_arr:
                continue
            t_new = float(t_new)
            self._dead_pending.add(seq)
            if self._gate is not None:
                self._dead_gate.add(seq)
            heapq.heappush(self._pending, (t_new, self._seq, dag))
            if self._gate is not None:
                heapq.heappush(self._gate,
                               (self.policy.arrival_floor(t_new, dag),
                                t_new, self._seq, dag))
            self._seq += 1
            moved.append(dag.name)
        self._drain_pending()
        return moved

    def _apply_event_live(self, kind: str, pe_map: dict,
                          link_map: dict) -> None:
        """Apply a horizon event to the live engine, append it to the
        durable log, and rebuild the selector — floors move candidate
        keys exactly like a repool does, so the same rebind contract
        applies."""
        eng = self.eng
        eng.apply_horizon_event(kind, pe_map, link_map)
        self.horizon_events.append(
            (len(eng.assignments), kind, dict(pe_map), dict(link_map)))
        eng._newly = list(eng._ready)
        self.policy.rebind()
        self._gate = None
        if self.sanitizer is not None:
            self.sanitizer.on_horizon_event(kind, pe_map, link_map)

    def _remap_horizon_events(self, old: Sequence[Assignment],
                              lost_names: set) -> List[Tuple[int, str, dict,
                                                             dict]]:
        """Re-index the horizon-event log against a surviving history: an
        event that fired after ``i`` placements fires after the number of
        *survivors* among those first ``i`` placements."""
        if not self.horizon_events:
            return []
        prefix = [0] * (len(old) + 1)
        c = 0
        for i, a in enumerate(old):
            if a.task not in lost_names:
                c += 1
            prefix[i + 1] = c
        n = len(old)
        return [(prefix[min(max(int(idx), 0), n)], kind, pe_map, link_map)
                for idx, kind, pe_map, link_map in self.horizon_events]

    def _site_fragment(self, site: str) -> ResourcePool:
        """Rejoin fragment for a whole site: its PEs, intra-site links,
        and its WAN attachments to sites currently up and uncut."""
        fed = self._require_federation()
        s = fed.site(site)
        links = list(s.links)
        for w in fed.wan:
            if site not in w.pair:
                continue
            other = w.b if w.a == site else w.a
            if other in self._down_sites or w.pair in self._cut:
                continue
            links.extend(fed._expand_wan(w))
        return ResourcePool(list(s.pes), links, fed.intra_location_bandwidth,
                            site_of={loc: site for loc in s.locations})

    def partition(self, t: float, site: str, defer: object = (),
                  shed: object = 0) -> PartitionReport:
        """A WAN partition isolates ``site`` at time ``t`` — no work is
        lost, and nothing is cancelled: this is *pricing, not surgery*.

        The site's quarantine deadline (:attr:`site_backoff` — repeat
        partitions back off exponentially) doubles as the heal estimate:
        ``pe_free`` of every unreachable-site PE and ``link_free`` of
        every cut WAN key are monotone-raised to it, so through the
        existing per-(PE, link) offset heaps the engine (a) keeps placing
        reachable-site work normally — degraded mode — and (b) defers
        cross-partition work to the deadline instead of cancelling it.
        Outputs whose only copies sit on the far side are effectively
        lost *for consumers across the partition* (any transfer from them
        prices in the deadline) but stay trusted: :meth:`heal` inside the
        window restores the floors with no recompute.

        ``defer`` names pending instances (or ``"all"``) to re-time to
        the deadline — their admission-gate value floors shift with them
        (see :meth:`_retime_pending`). ``shed`` drops pending instances
        lowest-value-first, restricted to the deferred (far-side-bound)
        set when one exists (``"auto"``: proportional to the unreachable
        PE share).

        The raise is appended to the durable :attr:`horizon_events` log;
        continuing this driver stays byte-identical to
        :func:`restart_from_history` with that log (chaos-pinned at site
        granularity in tests/test_chaos.py)."""
        fed = self._require_federation()
        t = float(t)
        if site not in fed.site_names:
            raise ValueError(f"unknown site {site!r}")
        if site in self._partition_saved:
            raise ValueError(f"site {site!r} is already partitioned")
        if site in self._down_sites:
            raise ValueError(f"site {site!r} is down, not partitioned")
        if site == fed.home:
            raise ValueError("cannot partition the home site away from "
                             "itself — partition the far site instead")
        pairs = fed.wan_pairs_touching(site)
        deadline = self.site_backoff.record_failure(site, t)
        self._cut |= pairs
        reach = fed.reachable(cut=self._cut, down=self._down_sites)
        unreachable = [s for s in fed.site_names
                       if s not in reach and s not in self._down_sites]
        eng = self.eng
        idx_of = eng._pi.idx_of
        pe_map: Dict[str, float] = {}
        pe_saved: Dict[str, Tuple[float, float]] = {}
        for s in unreachable:
            for nm in fed.site(s).pe_names:
                pj = idx_of.get(nm)
                if pj is not None and deadline > eng._pe_free[pj]:
                    pe_map[nm] = deadline
                    pe_saved[nm] = (deadline, eng._pe_free[pj])
        link_map: Dict[Tuple[str, str], float] = {}
        link_saved: Dict[Tuple[str, str], Tuple[float, float]] = {}
        for pr in pairs:
            a, b = sorted(pr)
            for lk in fed.wan_keys(a, b):
                if lk in eng._pi.links:
                    cur = eng.link_free.get(lk, 0.0)
                    if deadline > cur:
                        link_map[lk] = deadline
                        link_saved[lk] = (deadline, cur)
        self._apply_event_live("raise", pe_map, link_map)
        self._partition_saved[site] = {
            "pairs": pairs, "deadline": deadline,
            "pe": pe_saved, "link": link_saved,
        }
        deferred: List[str] = []
        if defer:
            want = None if defer == "all" else {str(x) for x in defer}
            retime: Dict[str, float] = {}
            for t_arr, _seq, dag in self._live_pending():
                if want is not None and dag.name not in want:
                    continue
                if t_arr >= deadline:
                    continue
                retime[dag.name] = deadline
                self._deferred_arrivals.setdefault(dag.name, t_arr)
            deferred = self._retime_pending(retime)
        if shed == "auto":
            n_pool = len(self.pool.pes)
            k = (-(-self._n_pending * len(pe_map) // n_pool)
                 if pe_map and n_pool else 0)
        else:
            k = int(shed)  # type: ignore[call-overload]
        shed_names = [dag.name for dag, _t in
                      self.shed_pending(k, within=deferred or None)]
        rep = PartitionReport(
            t=t, site=site, deadline=deadline,
            unreachable=tuple(unreachable), floored_pes=tuple(pe_map),
            floored_links=tuple(link_map), deferred=tuple(deferred),
            shed=tuple(shed_names))
        self.partitions.append(rep)
        return rep

    def heal(self, t: float, site: str) -> Optional[RecoveryReport]:
        """The WAN cut isolating ``site`` heals at time ``t``.

        *Within the quarantine window* (``t`` before the partition's
        deadline): the far side's outputs were never lost, only
        unreachable — the partition floors are conditionally restored
        (a horizon something was committed against since the raise is a
        fact and is kept), deferred pending instances re-time to
        ``max(original arrival, t)``, and **nothing is recomputed**.
        Returns None.

        *Past the window* (late heal — the deadline the floors promised
        expired while the site was still dark): placements made after the
        deadline assumed a heal that had not happened, so the far side's
        outputs can no longer be trusted. The floors are restored, then
        the event escalates to the PR-6 lost-work path
        (:meth:`fail` with the site's PEs + the cut keys, site-level
        quarantine only) and the physically-present site immediately
        rejoins. Returns that :class:`RecoveryReport`."""
        fed = self._require_federation()
        t = float(t)
        saved = self._partition_saved.pop(site, None)
        if saved is None:
            raise ValueError(f"site {site!r} is not partitioned")
        self._cut -= saved["pairs"]
        trusted = self.site_backoff.quarantined(site, t)
        if saved["pe"] or saved["link"]:
            self._apply_event_live("restore", saved["pe"], saved["link"])
        rep: Optional[RecoveryReport] = None
        if not trusted:
            site_pes = [p.name for p in self.pool.pes
                        if fed.site_of_pe(p.name) == site]
            keys = [lk for pr in saved["pairs"]
                    for lk in fed.wan_keys(*sorted(pr))]
            rep = self.fail(t, pes=site_pes, links=keys, quarantine=False)
            self.rejoin(t, self._site_fragment(site))
        retime = {nm: max(orig, t)
                  for nm, orig in self._deferred_arrivals.items()}  # det: ok key-addressed rebuild; admission order
        self._retime_pending(retime)
        self._deferred_arrivals.clear()
        return rep

    def fail_site(self, t: float, site: str,
                  shed: object = 0) -> RecoveryReport:
        """The whole site dies at time ``t`` (an edge box loses power, a
        DC rack drains): every PE of the site leaves the pool and its WAN
        attachments leave the link matrix (``drop_links`` — unlike a
        transient link drop, there is nothing left to route to), then the
        PR-6 lineage pass invalidates in-flight work and outputs whose
        only live copy sat on the site. Quarantine is tracked at site
        granularity (:attr:`site_backoff`): a flapping site's rejoin
        windows grow exponentially, but its individual PEs are not
        separately quarantined."""
        fed = self._require_federation()
        t = float(t)
        if site not in fed.site_names:
            raise ValueError(f"unknown site {site!r}")
        if site == fed.home:
            raise ValueError("cannot fail the home site (the driver and "
                             "raw data live there)")
        if site in self._down_sites:
            raise ValueError(f"site {site!r} is already down")
        saved = self._partition_saved.pop(site, None)
        if saved is not None:
            # a partitioned site dying outright: the cut dissolves into
            # the site loss (the partition's floors leave with the site's
            # PEs/WAN links — fail() scrubs them from the durable
            # horizon-event log along with the pool)
            self._cut -= saved["pairs"]
        self.site_backoff.record_failure(site, t)
        site_pes = [p.name for p in self.pool.pes
                    if fed.site_of_pe(p.name) == site]
        keys = fed.wan_keys_touching(site)
        rep = self.fail(t, pes=site_pes, links=keys, shed=shed,
                        quarantine=False, drop_links=True)
        self._down_sites.add(site)
        return rep

    def rejoin_site(self, t: float, site: str,
                    fragment: Optional[ResourcePool] = None
                    ) -> Tuple[List[str], List[str]]:
        """Re-admit a lost site at time ``t``: its PEs, intra-site links
        and WAN attachments (to sites currently up and uncut) return in
        one repool. Refused wholesale while the site's quarantine window
        (:attr:`site_backoff`) is open — site flap damping. ``fragment``
        overrides the default full-site fragment (partial recovery)."""
        fed = self._require_federation()
        t = float(t)
        if site not in self._down_sites:
            raise ValueError(f"site {site!r} is not down")
        if self.site_backoff.quarantined(site, t):
            return [], list(fed.site(site).pe_names)
        self._down_sites.discard(site)
        frag = fragment if fragment is not None else self._site_fragment(site)
        return self.rejoin(t, frag)

    def apply_health(self, monitor, now: float) -> Optional[RecoveryReport]:
        """End-to-end :class:`repro.core.elastic.HealthMonitor` wiring.

        Heartbeat-dead workers (``sweep_dead``) take the lost-work path —
        their in-flight placements and orphaned outputs are invalidated
        and resubmitted via :meth:`fail`. Convicted stragglers are a
        *transient* slow-down: they are excluded from the pool
        (``mark_dead`` — they may rejoin later) and rotated out with a
        plain :meth:`repool` via ``elastic.prune_pool``; their completed
        work is kept and nothing is recomputed. Returns the
        :class:`RecoveryReport` when a PE died, else None."""
        from repro_torch.core.elastic import prune_pool
        dead = monitor.sweep_dead(now)
        stragglers = monitor.stragglers()
        for w in stragglers:
            monitor.mark_dead(w)  # excluded (can rejoin later)
        pool_names = {p.name for p in self.pool.pes}
        report = None
        dead_in = [w for w in dead if w in pool_names]
        if dead_in:
            report = self.fail(now, dead_in)
        if any(w in {p.name for p in self.pool.pes} for w in stragglers):
            self.repool(prune_pool(self.pool, monitor))
        return report

    # -- results --------------------------------------------------------------
    def schedule(self) -> Schedule:
        return Schedule(self.eng.assignments, self.eng.pool, self.policy_name)

    def result(self, label: str = "",
               wall_seconds: float = 0.0) -> OnlineRunResult:
        sched = self.schedule()
        return OnlineRunResult(
            label or self.eng.pool.describe(), self.policy_name,
            sched.makespan, sched.mean_utilization, sched.total_energy,
            sched.location_split(), sched, wall_seconds=wall_seconds,
            n_events=self.n_events, max_live=self.max_live,
            completions=list(self.completions),
            n_failures=len(self.recoveries),
            n_lost_tasks=sum(len(r.lost) for r in self.recoveries),
            lost_exec_seconds=sum(r.lost_exec_seconds
                                  for r in self.recoveries),
            cancelled=list(self.cancelled_instances),
            shed=list(self.shed_instances),
            n_preemptions=self.n_preemptions,
            n_displaced=self.n_displaced,
            n_batched_steps=self.n_batched_steps)


def run_online(workload: PipelineDAG, pool: ResourcePool,
               cost: Optional[CostModel] = None, policy: str = "eft",
               n_instances: int = 100, period: float = 0.0,
               label: str = "", curves: object = None,
               **policy_kw) -> OnlineRunResult:
    """Streaming counterpart of :func:`repro.core.simulator.run_instances`:
    submit ``n_instances`` copies of ``workload`` (one every ``period``
    seconds) through the online driver. Produces byte-identical schedules
    to the batch path for every policy (pinned by tests/test_online.py).
    ``curves`` attaches per-instance SLO curves in any form
    :func:`repro.core.vos.normalize_curves` accepts — consumed by the VoS
    policy, ignored by the rest (the same spelling as ``run_instances``
    and ``sweep_policies``)."""
    t0 = time.perf_counter()
    if curves is not None and policy == "vos":
        policy_kw.setdefault("curves",
                             vos_mod.normalize_curves(curves, n_instances))
    drv = OnlineDriver(pool, cost, policy=policy, **policy_kw)
    for i in range(n_instances):
        drv.submit(workload.instance(i),
                   arrival_t=i * period if period > 0 else 0.0)
    drv.run()
    return drv.result(label=label, wall_seconds=time.perf_counter() - t0)


def restart_from_history(pool: ResourcePool, cost: Optional[CostModel],
                         policy: str,
                         admitted: Sequence[Tuple[PipelineDAG, float]],
                         history: Sequence[Assignment],
                         pending: Sequence[Tuple[PipelineDAG, float]] = (),
                         loc_of: Optional[Mapping[str, str]] = None,
                         retry_floors: Optional[Mapping[str, float]] = None,
                         cancelled: Sequence[str] = (),
                         horizon_events: Sequence[Tuple[int, str, dict,
                                                        dict]] = (),
                         **policy_kw) -> OnlineDriver:
    """Rebuild a live driver on ``pool`` from the durable record — the
    restart-from-scratch dual of :meth:`OnlineDriver.repool`.

    ``admitted`` lists the (dag, arrival) instances the original run had
    admitted, in admission order; ``history`` its placement record, in
    placement order; ``pending`` any not-yet-admitted submissions
    (:meth:`OnlineDriver.pending_submissions`). ``loc_of`` maps PE names
    absent from ``pool`` (removed by an elastic shrink) to their location,
    so their history can be replayed (see
    :meth:`repro.core.schedulers.OnlineEngine.replay`). For the VoS policy
    the durable record also includes the per-instance curve map — pass
    ``curves=original.slo_curves()`` (it is policy state: curves attached
    via ``submit(curve=...)`` are not derivable from the DAGs, and
    omitting them silently falls back to the default curve). Continuing
    the returned driver must produce the same remaining placements as the
    repooled original — differentially tested in tests/test_online.py and
    tests/test_vos_curves.py.

    After failures the durable record additionally carries
    ``retry_floors`` (:attr:`OnlineDriver.retry_floors` — cumulative
    resubmission arrival floors from retry backoff) and ``cancelled``
    (:attr:`OnlineDriver.cancelled_instances` — instances withdrawn after
    a task exhausted its retry budget); ``history`` is then the
    *surviving* assignment record :meth:`OnlineDriver.fail` left behind.
    Continuing the rebuilt driver is byte-identical to continuing the
    failed one — the recovery differential in tests/test_recovery.py.

    After site-granularity events the record also carries
    ``horizon_events`` (:attr:`OnlineDriver.horizon_events` — the
    partition raise/restore log, already indexed against ``history``):
    trusted replay books transfers FIFO, so the floors are re-applied
    *between* the same bookings they were applied between live
    (:meth:`OnlineEngine.replay_with_horizons`) — flat replay with floors
    applied before or after would diverge whenever bookings straddle a
    partition event.
    """
    drv = OnlineDriver(pool, cost, policy=policy, **policy_kw)
    for dag, t in admitted:
        drv._admit_now(dag, t)
    eng = drv.eng
    if retry_floors:
        id_of = eng._di.id_of
        for nm, fl in retry_floors.items():  # det: ok independent per-task floor raise; order-free
            eng.raise_arrival(id_of[nm], fl)
        drv.retry_floors = dict(retry_floors)
    cancelled_set = set(cancelled)
    if cancelled_set:
        in_history = {a.task for a in history}
        names = eng._di.names
        for inst in drv.instances:
            if inst.name in cancelled_set:
                inst.cancelled = True
                drv.cancelled_instances.append(inst.name)
                eng.cancel([tid for tid in range(
                    inst.first_tid, inst.first_tid + inst.n_tasks)
                    if names[tid] not in in_history])
    # trust the recorded times: a post-failure history is gapped (lost
    # tasks' transfer bookings are vacated), so strict recompute-replay
    # would legitimately diverge; for complete histories trusted booking
    # is float-identical to the strict path (see OnlineEngine.replay)
    if horizon_events:
        drv.horizon_events = [tuple(e) for e in horizon_events]
        drv.eng.replay_with_horizons(history, drv.horizon_events, loc_of,
                                     trust=True)
    else:
        drv.eng.replay(history, loc_of, trust=True)
    drv.n_events = len(history)
    # sync instance book-keeping with the replayed placements
    finish = drv.eng._finish
    for inst in drv.instances:
        fins = [f for f in finish[inst.first_tid:inst.first_tid + inst.n_tasks]
                if f is not None]
        inst.finish = max(fins, default=0.0)
        if inst.cancelled:
            inst.remaining = 0
            drv._live -= 1
            continue
        inst.remaining = inst.n_tasks - len(fins)
        if inst.remaining == 0 and not inst.completed:
            inst.completed = True
            drv._live -= 1
            drv.completions.append((inst.name, inst.finish))
            drv._retire(inst)
    # telemetry is rebuilt, not recovered: the original run's live-set
    # high-water and completion (retirement) order are not in the durable
    # record, so the high-water restarts from the current live set and
    # replayed completions are ordered by completion time
    drv.completions.sort(key=lambda c: (c[1], c[0]))
    drv.max_live = drv._live
    for dag, t in pending:
        drv.submit(dag, t)
    return drv
