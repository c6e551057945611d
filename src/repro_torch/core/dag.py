# fmt: off
# A copy of src/repro/core/dag.py, kept in its hand-aligned layout so the
# two stay diffable line for line; only the imports name repro_torch.
"""Pipeline DAG representation (paper §4: compiler-integrated runtime).

The paper's compiler converts a Data-Science workflow into a Directed
Acyclic Graph where

  * a node is a *task* — a function used in the application domain
    (e.g. ``k-means``), carried as a "flexible binary" so the runtime can
    invoke it on any available compute resource;
  * an edge is a predecessor→successor data dependency annotated with the
    number of bytes transferred.

Here a :class:`Task` carries per-backend callables (the flexible binary:
a host/numpy implementation and a device/torch implementation with
identical semantics) plus the cost annotations the
schedulers consume (work estimate, in/out bytes, preferred families).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DAGIndex:
    """Immutable int-id view of a :class:`PipelineDAG` snapshot.

    The scheduling engine's inner loop works on dense integer ids instead of
    name-keyed dicts: ``tasks[i]`` is the Task with id ``i``, ``preds[i]`` /
    ``succs[i]`` are tuples of predecessor/successor ids, and ``topo`` lists
    ids in the same deterministic topological order as
    :meth:`PipelineDAG.topological_order`. Built once per DAG version via
    :meth:`PipelineDAG.index` and cached until the DAG mutates.
    """

    tasks: Tuple[Task, ...]
    names: Tuple[str, ...]
    id_of: Dict[str, int]
    preds: Tuple[Tuple[int, ...], ...]
    succs: Tuple[Tuple[int, ...], ...]
    topo: Tuple[int, ...]


@dataclasses.dataclass
class Task:
    """One node of a DS pipeline DAG.

    Attributes:
      name: unique name within the DAG.
      op: operator kind (``"kmeans"``, ``"sql_transform"``, ...). Used to look
        up execution-time/energy entries in the cost model.
      work: abstract work units (calibrated FLOP-scale number); the cost model
        divides by PE throughput for that op kind.
      out_bytes: bytes this task ships to each successor.
      in_bytes: bytes of raw input this task reads from the *source* (only
        meaningful for source tasks: the paper charges the initial sensor
        data upload when a source task is placed in the backend).
      backends: optional map backend-name → callable implementing the task
        ("flexible binary"). Keys: ``"host"``, ``"device"``.
      params: static params forwarded to the callable.
    """

    name: str
    op: str
    work: float = 1.0
    out_bytes: float = 0.0
    in_bytes: float = 0.0
    backends: Dict[str, Callable[..., Any]] = dataclasses.field(default_factory=dict)
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __hash__(self) -> int:
        return hash(self.name)


class PipelineDAG:
    """A DAG of :class:`Task` with topological utilities.

    Self-contained (no networkx) so scheduler behaviour is fully transparent
    and deterministic; edge order is insertion order.
    """

    def __init__(self, name: str = "pipeline") -> None:
        self.name = name
        self._tasks: Dict[str, Task] = {}
        self._succ: Dict[str, List[str]] = {}
        self._pred: Dict[str, List[str]] = {}
        self._version = 0
        self._index: Optional[DAGIndex] = None
        self._index_version = -1

    # -- construction -------------------------------------------------------
    def add_task(self, task: Task) -> Task:
        if task.name in self._tasks:
            raise ValueError(f"duplicate task {task.name!r}")
        self._tasks[task.name] = task
        self._succ[task.name] = []
        self._pred[task.name] = []
        self._version += 1
        return task

    def add_edge(self, src: str, dst: str) -> None:
        if src not in self._tasks or dst not in self._tasks:
            raise KeyError(f"unknown task in edge {src!r}->{dst!r}")
        if dst in self._succ[src]:
            return
        self._succ[src].append(dst)
        self._pred[dst].append(src)
        self._version += 1
        # cheap cycle guard: dst must not reach src
        if self._reaches(dst, src):
            self._succ[src].remove(dst)
            self._pred[dst].remove(src)
            raise ValueError(f"edge {src!r}->{dst!r} would create a cycle")

    def _add_edge_unchecked(self, src: str, dst: str) -> None:
        """Edge insert without the cycle DFS — for :meth:`instance`/:func:`merge`,
        which copy edges of an already-acyclic graph and cannot create cycles."""
        self._succ[src].append(dst)
        self._pred[dst].append(src)
        self._version += 1

    def chain(self, *names: str) -> None:
        for a, b in zip(names, names[1:], strict=False):
            self.add_edge(a, b)

    def _reaches(self, a: str, b: str) -> bool:
        stack, seen = [a], set()
        while stack:
            n = stack.pop()
            if n == b:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self._succ[n])
        return False

    # -- queries -------------------------------------------------------------
    @property
    def tasks(self) -> List[Task]:
        return list(self._tasks.values())

    def task(self, name: str) -> Task:
        return self._tasks[name]

    def __len__(self) -> int:
        return len(self._tasks)

    def __contains__(self, name: str) -> bool:
        return name in self._tasks

    def successors(self, name: str) -> List[Task]:
        return [self._tasks[n] for n in self._succ[name]]

    def predecessors(self, name: str) -> List[Task]:
        return [self._tasks[n] for n in self._pred[name]]

    def sources(self) -> List[Task]:
        return [t for t in self.tasks if not self._pred[t.name]]

    def sinks(self) -> List[Task]:
        return [t for t in self.tasks if not self._succ[t.name]]

    def topological_order(self) -> List[Task]:
        indeg = {n: len(p) for n, p in self._pred.items()}  # det: ok task-insertion order is the topo tie-break contract
        queue = [n for n, d in indeg.items() if d == 0]  # det: ok task-insertion order is the topo tie-break contract
        out: List[Task] = []
        i = 0
        while i < len(queue):
            n = queue[i]
            i += 1
            out.append(self._tasks[n])
            for s in self._succ[n]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    queue.append(s)
        if len(out) != len(self._tasks):
            raise ValueError("DAG contains a cycle")
        return out

    def index(self) -> DAGIndex:
        """Int-id adjacency snapshot (cached; rebuilt when the DAG mutates)."""
        if self._index is None or self._index_version != self._version:
            names = tuple(self._tasks)
            id_of = {n: i for i, n in enumerate(names)}
            self._index = DAGIndex(
                tasks=tuple(self._tasks.values()),
                names=names,
                id_of=id_of,
                preds=tuple(tuple(id_of[p] for p in self._pred[n]) for n in names),
                succs=tuple(tuple(id_of[s] for s in self._succ[n]) for n in names),
                topo=tuple(id_of[t.name] for t in self.topological_order()),
            )
            self._index_version = self._version
        return self._index

    # -- analysis helpers used by schedulers ---------------------------------
    def upward_rank(self, exec_estimate: Callable[[Task], float],
                    comm_estimate: Callable[[Task], float]) -> Dict[str, float]:
        """HEFT-style upward rank: critical-path-to-exit length per task."""
        rank: Dict[str, float] = {}
        for t in reversed(self.topological_order()):
            succ_term = max(
                (comm_estimate(t) + rank[s.name] for s in self.successors(t.name)),
                default=0.0,
            )
            rank[t.name] = exec_estimate(t) + succ_term
        return rank

    def total_work(self) -> float:
        return sum(t.work for t in self.tasks)

    def instance(self, idx: int) -> "PipelineDAG":
        """Clone this DAG as instance ``idx`` (task names suffixed ``#idx``).

        The paper submits 100 *instances* of the DS workload at once; each
        instance is an independent copy competing for the same pool.

        Cloning renames but never re-shapes, so the clone's
        :class:`DAGIndex` is derived from this DAG's cached index — the
        integer adjacency and topo tuples are *shared* (ids are identical
        under renaming) and the per-instance cost drops to the task
        renames plus one name table. This is the per-arrival setup cost
        of every online trace generator, so it is deliberately O(tasks)
        with no topological re-sort.
        """
        base = self.index()
        suffix = f"#{idx}"
        g = PipelineDAG(name=f"{self.name}{suffix}")
        names = tuple(n + suffix for n in base.names)
        # direct constructor, not dataclasses.replace: same shallow copy
        # (backends/params dicts shared, like replace), ~2x cheaper, and
        # this runs once per task per arrival
        tasks = tuple(Task(nm, t.op, t.work, t.out_bytes, t.in_bytes,
                           t.backends, t.params)
                      for t, nm in zip(base.tasks, names, strict=True))
        g_tasks = g._tasks
        g_succ = g._succ
        g_pred = g._pred
        for i, nm in enumerate(names):
            g_tasks[nm] = tasks[i]
            g_succ[nm] = [names[s] for s in base.succs[i]]
            g_pred[nm] = [names[p] for p in base.preds[i]]
        g._version = 1
        g._index = DAGIndex(
            tasks=tasks, names=names,
            id_of={nm: i for i, nm in enumerate(names)},
            preds=base.preds, succs=base.succs, topo=base.topo)
        g._index_version = g._version
        return g


def merge(dags: Iterable[PipelineDAG], name: str = "merged") -> PipelineDAG:
    """Union several DAGs into one scheduling problem (no cross edges).

    Inputs are acyclic and node-disjoint copies, so edges are inserted via
    the unchecked fast path (the per-edge cycle DFS would be pure overhead
    on 1k-instance merges).
    """
    g = PipelineDAG(name=name)
    for d in dags:
        for t in d.tasks:
            g.add_task(t)
        for t in d.tasks:
            for s in d.successors(t.name):
                g._add_edge_unchecked(t.name, s.name)
    return g
