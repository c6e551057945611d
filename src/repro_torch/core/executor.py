"""Real execution of a scheduled DAG (the paper's workload manager, live).

The simulator predicts; the executor *runs*. Given a :class:`PipelineDAG`
whose tasks carry backends (the flexible binary) and a
:class:`~repro_torch.core.schedulers.Schedule`, it executes every task in
schedule order, routing each to its assigned PE's backend:

  * frontend PE → ``backends["host"]`` (numpy, the edge);
  * backend  PE → ``backends["device"]`` (torch on the VDC's device).

Inputs cross the host↔device boundary on the way in: a host task gets
numpy arrays, a device task tensors on the executor's device. Outputs flow
along DAG edges (predecessor order). Measured wall times, which wait for
the card, feed a :class:`~repro_torch.core.cost_model.LearnedCostModel`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.convert import from_reference, resolve_device, synchronize, to_numpy
from repro_torch.core.cost_model import LearnedCostModel
from repro_torch.core.dag import PipelineDAG, Task
from repro_torch.core.resources import FRONTEND, ResourcePool
from repro_torch.core.schedulers import Schedule


@dataclasses.dataclass
class TaskRun:
    task: str
    op: str
    pe: str
    backend: str
    seconds: float
    output: Any = None


@dataclasses.dataclass
class ExecutionReport:
    runs: List[TaskRun]
    outputs: Dict[str, Any]
    wall_seconds: float
    #: outputs that were computed but whose every copy sat on a PE that
    #: died (lineage loss — must be recomputed; see Executor.execute)
    lost: List[str] = dataclasses.field(default_factory=list)
    #: tasks not executed: assigned PE dead, or an input output was lost
    skipped: List[str] = dataclasses.field(default_factory=list)
    #: PE names dead at the end of the run
    dead: List[str] = dataclasses.field(default_factory=list)
    #: task name -> PE names holding a live copy of its output (producer
    #: plus every consumer that executed — the Spark-style fetch copies)
    copies: Dict[str, set] = dataclasses.field(default_factory=dict)

    def run(self, task: str) -> TaskRun:
        for r in self.runs:
            if r.task == task:
                return r
        raise KeyError(task)

    @property
    def by_backend(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.runs:
            out[r.backend] = out.get(r.backend, 0) + 1
        return out

    def complete(self, dag: PipelineDAG) -> bool:
        """True iff every task of ``dag`` has a live output."""
        return all(t.name in self.outputs for t in dag.tasks)


class Executor:
    """Executes a scheduled DAG with real backends.

    ``backend_of(pe)`` maps a PE to a backend key; the default sends
    frontend PEs to "host" and everything else to "device". Tasks lacking
    the chosen backend fall back to any available one (flexibility is the
    point of the flexible binary — semantics are identical). ``device`` is
    where device tasks run: the card unless the caller passes another
    device (the VDC's first device in the quickstart, the CPU in tests).
    """

    def __init__(
        self,
        pool: ResourcePool,
        backend_of: Optional[Callable[[str], str]] = None,
        learn_into: Optional[LearnedCostModel] = None,
        device: Optional[object] = None,
    ) -> None:
        self.pool = pool
        self._backend_of = backend_of or (
            lambda pe: "host" if self.pool.pe(pe).location == FRONTEND else "device"
        )
        self.learn_into = learn_into
        self.device = resolve_device(device)

    def _resolve(self, task: Task, pe: str) -> Tuple[str, Callable]:
        want = self._backend_of(pe)
        if want in task.backends:
            return want, task.backends[want]
        if task.backends:
            k = sorted(task.backends)[0]
            return k, task.backends[k]
        raise ValueError(f"task {task.name!r} has no executable backends")

    def _to_side(self, kind: str, args: List[Any]) -> List[Any]:
        if kind == "host":
            return to_numpy(args)
        return from_reference(args, self.device)

    def execute(
        self,
        dag: PipelineDAG,
        schedule: Schedule,
        inputs: Optional[Mapping[str, Any]] = None,
        *,
        injector=None,
        resume_from: Optional[ExecutionReport] = None,
    ) -> ExecutionReport:
        """Execute ``schedule`` with real backends.

        ``injector`` is any object whose ``at(step)`` returns the events due
        before the ``step``-th task of the execution order, each with
        ``kind``, ``worker`` and (for ``"slow"``) ``factor``. A ``"die"``
        event kills the named PE — tasks assigned to it are skipped, and
        every output whose only live copies sat on it is dropped (lineage
        loss; a consumer that already executed holds a fetched copy, so
        those survive). ``"slow"`` scales the worker's measured seconds,
        ``"rejoin"`` revives it (its lost data stays lost). ``"partition"``
        moves the named PE to the far side of a network cut: its outputs
        and copies stay alive, but a task may only fetch an input from a
        copy-holder on its *own* side — both sides keep executing what they
        can reach, and cross-partition consumers are skipped. ``"heal"``
        reconnects the PE; a later ``resume_from`` pass then recomputes
        exactly the skipped subgraph. ``resume_from`` continues from a
        previous (failed) report: surviving outputs and copy sets are
        carried over and only missing work runs.

        A task's seconds include moving its inputs across the host↔device
        boundary and wait for the card before the clock is read."""
        inputs = dict(inputs or {})
        # tie-break equal start times by topological order, not name: a
        # zero-duration predecessor can share its successor's start time,
        # and name order may put the successor first (outputs[p] missing)
        topo_pos = {t.name: i for i, t in enumerate(dag.topological_order())}
        order = sorted(schedule.assignments, key=lambda a: (a.start, topo_pos[a.task]))
        outputs: Dict[str, Any] = dict(resume_from.outputs) if resume_from else {}
        copies: Dict[str, set] = (
            {nm: set(cs) for nm, cs in resume_from.copies.items()}  # det: ok key-addressed rebuild of the resume record
            if resume_from
            else {}
        )
        dead: set = set(resume_from.dead) if resume_from else set()
        # partitions are injector-scoped: a fresh execute() call starts
        # with a whole network (the cut, unlike death, is not durable
        # state of the report — resume-after-heal must see one side)
        unreachable: set = set()
        slow: Dict[str, float] = {}
        runs: List[TaskRun] = []
        lost: List[str] = []
        skipped: List[str] = []
        t_all = time.perf_counter()
        for step, a in enumerate(order):
            if injector is not None:
                for ev in injector.at(step):
                    if ev.kind == "die":
                        dead.add(ev.worker)
                        slow.pop(ev.worker, None)
                        # the PE's copies die with it; an output with no
                        # copy left anywhere is lost (lineage recompute)
                        for nm, cs in copies.items():  # det: ok copies insert in execution order (deterministic)
                            cs.discard(ev.worker)
                            if not cs and nm in outputs:
                                del outputs[nm]
                                lost.append(nm)
                    elif ev.kind == "slow":
                        slow[ev.worker] = ev.factor
                    elif ev.kind == "rejoin":
                        dead.discard(ev.worker)
                        slow.pop(ev.worker, None)
                    elif ev.kind == "partition":
                        unreachable.add(ev.worker)
                    elif ev.kind == "heal":
                        unreachable.discard(ev.worker)
            if resume_from is not None and a.task in outputs:
                continue  # computed before the failure; its copy survived
            task = dag.task(a.task)
            preds = dag.predecessors(task.name)

            def _fetchable(p: Task, a=a) -> bool:
                # an input is usable iff some live copy-holder sits on the
                # same side of the cut as the consumer (same-side fetch)
                if p.name not in outputs:
                    return False
                side = a.pe in unreachable
                return any(
                    c not in dead and (c in unreachable) == side
                    for c in copies.get(p.name, ())
                )

            if a.pe in dead or not all(_fetchable(p) for p in preds):
                skipped.append(task.name)
                continue
            args = [outputs[p.name] for p in preds]
            if task.name in inputs:
                args = [inputs[task.name]] + args
            kind, fn = self._resolve(task, a.pe)
            t0 = time.perf_counter()
            out = synchronize(fn(*self._to_side(kind, args), **task.params))
            dt = (time.perf_counter() - t0) * slow.get(a.pe, 1.0)
            outputs[task.name] = out
            copies[task.name] = {a.pe}
            for p in preds:
                # consumer keeps a fetched copy of each input
                copies.setdefault(p.name, set()).add(a.pe)
            runs.append(TaskRun(task.name, task.op, a.pe, kind, dt, out))
            if self.learn_into is not None:
                self.learn_into.observe(task, self.pool.pe(a.pe), dt)
        report = ExecutionReport(
            runs,
            outputs,
            time.perf_counter() - t_all,
            lost=lost,
            skipped=skipped,
            dead=sorted(dead),
            copies=copies,
        )
        from repro_torch.core import sanitize

        if sanitize.enabled():
            sanitize.check_execution_report(report, dag)
        return report
