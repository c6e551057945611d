# fmt: off
# A copy of src/repro/core/schedulers_reference.py, kept in its hand-aligned layout so the
# two stay diffable line for line; only the imports name repro_torch.
"""Frozen O(|ready|·|PE|)-per-step reference engine (the seed implementation).

This is the pre-optimization list-scheduling engine, kept verbatim as the
behavioural oracle for the incremental engine in
:mod:`repro.core.schedulers`: differential tests schedule the same problem
through both and assert byte-identical assignment lists. It is quadratic in
the ready set and recomputes ``ready_at``/``exec_start`` from scratch per
candidate — do not use it for large sweeps; use ``repro.core.schedulers``.

Only :func:`schedule_reference` (and ``REFERENCE_SCHEDULERS``) is public API
here; ``Assignment``/``Schedule`` are imported from the live module so the
two engines’ outputs compare directly.
"""


from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.cost_model import CostModel
from repro_torch.core.dag import PipelineDAG, Task
from repro_torch.core.resources import ProcessingElement, ResourcePool
from repro_torch.core.schedulers import Assignment, Schedule

# ---------------------------------------------------------------------------
# The shared list-scheduling engine
# ---------------------------------------------------------------------------

class _ReferenceEngine:
    """Deterministic list-scheduling engine with contended links and
    dispatch-holds-PE semantics.

    Paper-faithful runtime model (Fig. 4): the workload manager dispatches a
    *ready* task (all predecessors finished) to a PE; from that moment the
    PE is **held** while the manager "manages the data transfers to and from
    the PEs"; execution starts when the inputs have arrived. Consequently a
    PE's *busy* time includes its input-transfer stalls — which is exactly
    why cost-blind policies (RR) lose utilization on cross-link placements.

    Cross-location transfers are *booked* FIFO per link, so a shared slow
    channel — the paper's 12 Mbps edge↔DC link — serialises bulk uploads
    exactly as in the paper's server-only configuration (RQ1).
    Intra-location moves are free.
    """

    def __init__(self, dag: PipelineDAG, pool: ResourcePool, cost: CostModel,
                 arrival: Optional[Mapping[str, float]] = None,
                 contended_links: bool = True) -> None:
        self.dag = dag
        self.pool = pool
        self.cost = cost
        self.arrival = dict(arrival or {})
        self.contended_links = contended_links
        self.pe_free: Dict[str, float] = {p.name: 0.0 for p in pool.pes}
        self.link_free: Dict[Tuple[str, str], float] = {}
        self.finish: Dict[str, float] = {}
        self.placed: Dict[str, ProcessingElement] = {}
        self.assignments: List[Assignment] = []
        self._n_preds_left: Dict[str, int] = {
            t.name: len(dag.predecessors(t.name)) for t in dag.tasks}
        self._ready: List[str] = [t.name for t in dag.topological_order()
                                  if self._n_preds_left[t.name] == 0]

    # -- link booking ---------------------------------------------------------
    def _xfer_arrival(self, src_loc: str, dst_loc: str, nbytes: float,
                      avail: float, book: bool) -> float:
        """When does a transfer of nbytes (startable at `avail`) arrive?"""
        if nbytes <= 0 or src_loc == dst_loc:
            return avail
        dur = self.pool.transfer_time(src_loc, dst_loc, nbytes)
        if not self.contended_links:
            return avail + dur
        key = (src_loc, dst_loc)
        start = max(avail, self.link_free.get(key, 0.0))
        arrive = start + dur
        if book:
            self.link_free[key] = arrive  # det: ok frozen reference engine's own mutator
        return arrive

    # -- timing queries -------------------------------------------------------
    def ready_at(self, task: Task) -> float:
        """When the task becomes dispatchable (PE-independent)."""
        t = self.arrival.get(task.name, 0.0)
        for p in self.dag.predecessors(task.name):
            t = max(t, self.finish[p.name])
        return t

    def est(self, task: Task, pe: ProcessingElement) -> float:
        """Hold start: when the PE starts being reserved for the task."""
        return max(self.pe_free[pe.name], self.ready_at(task))

    def exec_start(self, task: Task, pe: ProcessingElement,
                   hold: float, book: bool = False) -> float:
        """When inputs have arrived at `pe` (transfers start at `hold`)."""
        t = hold
        if task.in_bytes > 0 and pe.location != self.cost.data_home:
            t = max(t, self._xfer_arrival(self.cost.data_home, pe.location,
                                          task.in_bytes, hold, book))
        for p in self.dag.predecessors(task.name):
            src = self.placed[p.name]
            t = max(t, self._xfer_arrival(src.location, pe.location,
                                          p.out_bytes, hold, book))
        return t

    def eft(self, task: Task, pe: ProcessingElement) -> float:
        hold = self.est(task, pe)
        return (self.exec_start(task, pe, hold)
                + self.cost.exec_time(task, pe))

    def place(self, task: Task, pe: ProcessingElement,
              start: Optional[float] = None) -> Assignment:
        hold = self.est(task, pe) if start is None else start
        xstart = self.exec_start(task, pe, hold, book=True)
        dur = self.cost.exec_time(task, pe)
        f = xstart + dur
        a = Assignment(task.name, task.op, pe.name, hold, f,
                       comm_wait=xstart - hold,
                       energy=self.cost.energy(task, pe))
        self.assignments.append(a)
        self.pe_free[pe.name] = max(self.pe_free[pe.name], f)  # det: ok frozen reference engine's own mutator
        self.finish[task.name] = f
        self.placed[task.name] = pe
        self._ready.remove(task.name)
        for succ in self.dag.successors(task.name):
            self._n_preds_left[succ.name] -= 1
            if self._n_preds_left[succ.name] == 0:
                self._ready.append(succ.name)
        return a

    @property
    def ready(self) -> List[Task]:
        return [self.dag.task(n) for n in self._ready]

    def done(self) -> bool:
        return not self._ready

    def schedule_obj(self, policy: str) -> Schedule:
        return Schedule(self.assignments, self.pool, policy)


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

def _rank(dag: PipelineDAG, pool: ResourcePool, cost: CostModel) -> Dict[str, float]:
    return dag.upward_rank(lambda t: cost.mean_exec_time(t, pool),
                           lambda t: cost.mean_comm_time(t, pool))


def schedule_rr(dag: PipelineDAG, pool: ResourcePool, cost: CostModel,
                arrival: Optional[Mapping[str, float]] = None) -> Schedule:
    eng = _ReferenceEngine(dag, pool, cost, arrival)
    rr = itertools.cycle(pool.pes)
    while not eng.done():
        task = eng.ready[0]  # FIFO
        pe = next(rr)
        eng.place(task, pe)
    return eng.schedule_obj("rr")


def schedule_eft(dag: PipelineDAG, pool: ResourcePool, cost: CostModel,
                 arrival: Optional[Mapping[str, float]] = None) -> Schedule:
    eng = _ReferenceEngine(dag, pool, cost, arrival)
    rank = _rank(dag, pool, cost)
    while not eng.done():
        best: Tuple[float, float, str, Task, ProcessingElement] = None  # type: ignore
        for task in eng.ready:
            for pe in pool.pes:
                key = (eng.eft(task, pe), -rank[task.name], task.name)
                if best is None or key < best[:3]:
                    best = (*key, task, pe)
        eng.place(best[3], best[4])
    return eng.schedule_obj("eft")


def schedule_etf(dag: PipelineDAG, pool: ResourcePool, cost: CostModel,
                 arrival: Optional[Mapping[str, float]] = None) -> Schedule:
    """ETF — *Earliest Task First*: the task that became ready earliest is
    scheduled first, placed on the PE minimising its finish time.

    The paper describes ETF (like EFT) as a "sophisticated" policy that
    accounts for "the hierarchy of the resource pool, expected execution
    time and data communication overhead" and reports EFT ≈ ETF on both
    metrics; this FIFO-by-readiness + best-PE reading matches that (the
    classic Hwang ETF is kept as policy ``"etf_hwang"``).
    """
    eng = _ReferenceEngine(dag, pool, cost, arrival)
    while not eng.done():
        task = min(eng.ready, key=lambda t: (eng.ready_at(t), t.name))
        pe = min(pool.pes, key=lambda p: (eng.eft(task, p), p.name))
        eng.place(task, pe)
    return eng.schedule_obj("etf")


def schedule_etf_hwang(dag: PipelineDAG, pool: ResourcePool, cost: CostModel,
                       arrival: Optional[Mapping[str, float]] = None) -> Schedule:
    """Classic ETF (Hwang et al.): among (ready task, PE) pairs pick the one
    with the earliest achievable *start* time (beyond-paper variant)."""
    eng = _ReferenceEngine(dag, pool, cost, arrival)
    rank = _rank(dag, pool, cost)
    while not eng.done():
        best = None
        for task in eng.ready:
            for pe in pool.pes:
                # earliest start; break ties toward shorter finish, then rank
                key = (eng.est(task, pe), eng.eft(task, pe), -rank[task.name],
                       task.name)
                if best is None or key < best[:4]:
                    best = (*key, task, pe)
        eng.place(best[4], best[5])
    return eng.schedule_obj("etf_hwang")


def schedule_minmin(dag: PipelineDAG, pool: ResourcePool, cost: CostModel,
                    arrival: Optional[Mapping[str, float]] = None) -> Schedule:
    eng = _ReferenceEngine(dag, pool, cost, arrival)
    while not eng.done():
        best = None
        for task in eng.ready:
            pe_best = min(pool.pes, key=lambda p, t=task: eng.eft(t, p))
            key = (eng.eft(task, pe_best), task.name)
            if best is None or key < best[:2]:
                best = (*key, task, pe_best)
        eng.place(best[2], best[3])
    return eng.schedule_obj("minmin")


def schedule_heft(dag: PipelineDAG, pool: ResourcePool, cost: CostModel,
                  arrival: Optional[Mapping[str, float]] = None) -> Schedule:
    """HEFT with insertion-based slot filling (beyond-paper)."""
    eng = _ReferenceEngine(dag, pool, cost, arrival)
    rank = _rank(dag, pool, cost)
    order = sorted(dag.tasks, key=lambda t: (-rank[t.name], t.name))
    # insertion slots per PE
    slots: Dict[str, List[Tuple[float, float]]] = {p.name: [] for p in pool.pes}

    def insertion_start(pe: ProcessingElement, ready_t: float, dur: float) -> float:
        """Earliest gap ≥ dur after ready_t on pe (or after last job)."""
        t = ready_t
        for (s, f) in slots[pe.name]:
            if t + dur <= s:
                return t
            t = max(t, f)
        return t

    for task in order:
        # HEFT processes in rank order; preds are guaranteed placed because
        # rank(pred) > rank(task) along edges.
        ready_t = eng.ready_at(task)
        best = None
        for pe in pool.pes:
            # estimated duration including (unbooked) transfer stall
            s_probe = max(ready_t, eng.pe_free[pe.name])
            dur = (eng.exec_start(task, pe, s_probe) - s_probe
                   + cost.exec_time(task, pe))
            s = insertion_start(pe, ready_t, dur)
            key = (s + dur, task.name)
            if best is None or key < best[:2]:
                best = (*key, pe, s)
        pe, s = best[2], best[3]
        # re-derive the stall at the inserted position and re-search until
        # the realised slot fits its gap (mirrors the incremental engine)
        while True:
            dur_act = (eng.exec_start(task, pe, s) - s
                       + cost.exec_time(task, pe))
            nxt = next((ss for (ss, _f) in slots[pe.name] if ss > s), None)
            if nxt is None or s + dur_act <= nxt:
                break
            s = insertion_start(pe, ready_t, dur_act)
        if task.name not in eng._ready:
            eng._ready.append(task.name)
        a = eng.place(task, pe, start=s)
        slots[pe.name].append((a.start, a.finish))
        slots[pe.name].sort()
    return eng.schedule_obj("heft")


def schedule_vos(dag: PipelineDAG, pool: ResourcePool, cost: CostModel,
                 arrival: Optional[Mapping[str, float]] = None,
                 value_fn: Optional[Callable[[Task, float], float]] = None,
                 energy_weight: float = 1e-4,
                 curves: Optional[Mapping[str, object]] = None,
                 default_curve=None) -> Schedule:
    """VoS-greedy: maximise time-dependent value minus energy cost.

    Mirrors the per-instance curve semantics of the live engine (``curves``
    maps instance id → :class:`repro.core.vos.ValueCurve`, ``default_curve``
    covers the rest, ``value_fn`` is the legacy callable escape hatch; with
    none of them, a soft/hard linear-decay default is derived from the
    critical-path horizon) so heterogeneous-SLO schedules can be
    differentially pinned against this exhaustive first-wins scan. Curve
    evaluation goes through ``ValueCurve.value`` in both engines — the one
    shared float path — so the comparison is byte-exact, not approximate.
    """
    from repro_torch.core import vos as vos_mod
    eng = _ReferenceEngine(dag, pool, cost, arrival)
    rank = _rank(dag, pool, cost)
    if isinstance(value_fn, vos_mod.ValueCurve):
        default_curve = value_fn
        value_fn = None
    if value_fn is None:
        cmap = dict(curves or {})
        fallback = default_curve
        if fallback is None:
            horizon = max(rank.values()) * 2.0 + 1e-9
            fallback = vos_mod.ValueCurve.linear_decay(horizon / 2,
                                                       horizon * 4)

        def rate(task, f, pe):
            c = cmap.get(vos_mod.instance_id(task.name), fallback)
            ew = c.energy_weight
            if ew is None:
                ew = energy_weight
            return c.value(f) - ew * cost.energy(task, pe)
    else:
        def rate(task, f, pe):
            return value_fn(task, f) - energy_weight * cost.energy(task, pe)
    while not eng.done():
        best = None
        for task in eng.ready:
            for pe in pool.pes:
                f = eng.eft(task, pe)
                vos_rate = rate(task, f, pe)
                key = (-vos_rate, f, task.name)
                if best is None or key < best[:3]:
                    best = (*key, task, pe)
        eng.place(best[3], best[4])
    return eng.schedule_obj("vos")


REFERENCE_SCHEDULERS: Dict[str, Callable[..., Schedule]] = {
    "rr": schedule_rr,
    "etf": schedule_etf,
    "etf_hwang": schedule_etf_hwang,
    "eft": schedule_eft,
    "heft": schedule_heft,
    "minmin": schedule_minmin,
    "vos": schedule_vos,
}


def schedule_reference(dag: PipelineDAG, pool: ResourcePool, cost: CostModel,
                       policy: str = "eft",
                       arrival: Optional[Mapping[str, float]] = None,
                       **kw) -> Schedule:
    """Schedule with the frozen seed engine (slow; for differential tests)."""
    try:
        fn = REFERENCE_SCHEDULERS[policy]
    except KeyError:
        raise ValueError(
            f"unknown policy {policy!r}; one of "
            f"{sorted(REFERENCE_SCHEDULERS)}") from None
    return fn(dag, pool, cost, arrival, **kw)
