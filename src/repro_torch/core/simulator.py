# fmt: off
# A copy of src/repro/core/simulator.py, kept in its hand-aligned layout so the
# two stay diffable line for line; only the imports name repro_torch.
"""Discrete-event experiment drivers (the paper's runtime emulation, §4).

Reproduces the two experiments of the paper:

  * **Experiment 1** (Fig. 6): fix the policy to EFT and sweep resource-pool
    configurations — ARM×{1..3} × Xeon×{1..3} (with 1 Volta, 1 V100,
    1 Alveo), plus *Edge-only* (3 ARM + 1 Volta) and *Server-only*
    (3 Xeon + 1 V100 + 1 Alveo) — running 100 instances of the 16-task DS
    workload submitted at once.
  * **Experiment 2** (Fig. 7): fix the best configuration from experiment 1
    and sweep the scheduling policy over {EFT, ETF, RR}; report execution
    time and mean resource utilisation.

Expected qualitative results (paper §4.2.1–4.2.2): Edge-only and
Server-only are the two *worst* configurations; more parallel resources →
lower makespan; EFT ≈ ETF, both ≈ 57 % faster and ≈ 21 % better-utilised
than RR.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import dag as dag_mod
from repro_torch.core.cost_model import CostModel
from repro_torch.core.dag import PipelineDAG
from repro_torch.core.resources import ResourcePool, paper_pool
from repro_torch.core.schedulers import Schedule, schedule
from repro_torch.core.vos import normalize_curves


@dataclasses.dataclass
class RunResult:
    label: str
    policy: str
    makespan: float
    mean_utilization: float
    total_energy: float
    location_split: Dict[str, int]
    schedule: Schedule
    #: scheduler wall-time in seconds (merge + policy run), for perf tracking
    wall_seconds: float = 0.0


def merge_instances(workload: PipelineDAG, n_instances: int,
                    period: float = 0.0, curves: object = None
                    ) -> Tuple[PipelineDAG, Dict[str, float],
                               Dict[str, object]]:
    """Replicate ``workload`` ×``n_instances`` into one scheduling problem.

    Returns ``(merged DAG, arrival map, per-instance curve map)`` — the
    arrival map is empty when ``period <= 0`` and the curve map when no
    ``curves`` are given. ``curves`` may be a mapping of instance id →
    :class:`repro.core.vos.ValueCurve`, a sequence of curves (instance
    ``i`` → ``curves[i]``), or a callable ``i -> curve``; the normalised
    id-keyed mapping rides along so :func:`run_instances` can hand the
    *same* SLO mix to the batch VoS scheduler and the online driver.

    :meth:`PipelineDAG.instance` copies each template task's cost fields
    (op, work, in/out bytes) verbatim, so the n replicas of a template task
    get bitwise-identical cost rows (``repro.core.cost_model.row_ids``) —
    which is exactly what lets the scheduling engine fold them into shared
    candidate classes on instance sweeps (tasks sharing a curve share a
    class; distinct SLO classes split). Build the merged problem once and
    reuse it across policies (:func:`sweep_policies` does) so the DAG index
    and cost tables are shared rather than rebuilt per policy."""
    instances = [workload.instance(i) for i in range(n_instances)]
    merged = dag_mod.merge(instances, name=f"{workload.name}x{n_instances}")
    arrival: Dict[str, float] = {}
    if period > 0:
        for i, inst in enumerate(instances):
            for t in inst.tasks:
                arrival[t.name] = i * period
    curve_map = normalize_curves(curves, n_instances) or {}
    return merged, arrival, curve_map


def run_instances(workload: PipelineDAG, pool: ResourcePool, cost: CostModel,
                  policy: str = "eft", n_instances: int = 100,
                  period: float = 0.0, label: str = "",
                  online: bool = False, sanitize: Optional[bool] = None,
                  curves: object = None,
                  _premerged: Optional[Tuple] = None,
                  **policy_kw) -> RunResult:
    """Submit ``n_instances`` copies of ``workload`` (all at once, or one
    every ``period`` seconds) and schedule them on ``pool``.

    Instance merging uses the acyclic fast path in :func:`repro.core.dag.merge`
    and the incremental engine in :mod:`repro.core.schedulers`, so 1k-instance
    sweeps are tractable; ``wall_seconds`` records the scheduler cost.
    ``_premerged`` (from :func:`merge_instances`) skips the merge when the
    caller sweeps several policies over one problem; a curve map it carries
    is handed to the VoS policy (and ignored by the others).

    ``curves`` attaches per-instance SLO curves in any form
    :func:`repro.core.vos.normalize_curves` accepts (mapping, sequence or
    callable) — consumed by the VoS policy, ignored by the rest, the same
    spelling as ``run_online`` and ``sweep_policies``. E.g.
    ``run_instances(..., policy="vos", curves=slo_mix(n, horizon))`` runs a
    heterogeneous per-instance SLO sweep, batch or (``online=True``)
    streamed. Other keyword arguments go to the policy.

    ``online=True`` routes through the streaming driver
    (:func:`repro.core.online.run_online`): instances are admitted into a
    live engine as they arrive instead of merged up front — byte-identical
    schedules, per-event cost independent of ``n_instances``, and the extra
    telemetry of :class:`repro.core.online.OnlineRunResult`.

    ``sanitize=True`` (or ``REPRO_SANITIZE=1``) validates the emitted
    schedule against :mod:`repro.core.sanitize` — online runs check every
    placement as it happens, batch runs get a whole-schedule pass."""
    if curves is not None and policy == "vos":
        policy_kw.setdefault("curves",
                             normalize_curves(curves, n_instances))
    if _premerged is not None and len(_premerged) > 2 and _premerged[2] \
            and policy == "vos":
        policy_kw.setdefault("curves", _premerged[2])
    if online:
        from repro_torch.core.online import run_online
        return run_online(workload, pool, cost, policy=policy,
                          n_instances=n_instances, period=period, label=label,
                          sanitize=sanitize, **policy_kw)
    t0 = time.perf_counter()
    if _premerged is not None:
        merged, arrival = _premerged[0], _premerged[1]
    else:
        merged, arrival, _ = merge_instances(workload, n_instances, period)
    sched = schedule(merged, pool, cost, policy=policy, arrival=arrival,
                     **policy_kw)
    from repro_torch.core import sanitize as _sanitize
    if _sanitize.enabled(sanitize) and not _sanitize.enabled(None):
        # env-enabled runs were already validated inside the engine
        _sanitize.validate_schedule(sched, merged, cost, arrival,
                                    curves=policy_kw.get("curves"))
    return RunResult(label or pool.describe(), policy, sched.makespan,
                     sched.mean_utilization, sched.total_energy,
                     sched.location_split(), sched,
                     wall_seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Experiment 1 — resource-pool configuration sweep (paper Fig. 6)
# ---------------------------------------------------------------------------

def experiment1_configs() -> List[Tuple[str, ResourcePool]]:
    """The paper's 11 configurations."""
    configs: List[Tuple[str, ResourcePool]] = []
    for n_arm in (1, 2, 3):
        for n_xeon in (1, 2, 3):
            label = f"{n_arm}ARM+{n_xeon}Xeon"
            configs.append((label, paper_pool(n_arm=n_arm, n_xeon=n_xeon)))
    configs.append(("Edge only", paper_pool(n_arm=3, n_volta=1, n_xeon=0,
                                            n_v100=0, n_alveo=0)))
    configs.append(("Server only", paper_pool(n_arm=0, n_volta=0, n_xeon=3,
                                              n_v100=1, n_alveo=1)))
    return configs


def sweep_resource_configs(workload: PipelineDAG,
                           cost: Optional[CostModel] = None,
                           n_instances: int = 100,
                           policy: str = "eft") -> List[RunResult]:
    cost = cost or CostModel()
    out = []
    for label, pool in experiment1_configs():
        out.append(run_instances(workload, pool, cost, policy=policy,
                                 n_instances=n_instances, label=label))
    return out


def best_config(results: Sequence[RunResult]) -> RunResult:
    return min(results, key=lambda r: r.makespan)


# ---------------------------------------------------------------------------
# Experiment 2 — scheduling-policy sweep on the best config (paper Fig. 7)
# ---------------------------------------------------------------------------

def sweep_policies(workload: PipelineDAG, pool: Optional[ResourcePool] = None,
                   cost: Optional[CostModel] = None, n_instances: int = 100,
                   policies: Sequence[str] = ("eft", "etf", "rr"),
                   curves: object = None) -> List[RunResult]:
    """Sweep ``policies`` over one shared merged problem. ``curves`` (any
    form :func:`merge_instances` accepts) attaches per-instance SLO curves,
    consumed by the VoS policy and ignored by the rest."""
    cost = cost or CostModel()
    pool = pool or paper_pool()  # paper's best: 3 ARM+1 Volta | 3 Xeon+1 V100+1 Alveo
    premerged = merge_instances(workload, n_instances, curves=curves)
    out = []
    for pol in policies:
        out.append(run_instances(workload, pool, cost, policy=pol,
                                 n_instances=n_instances,
                                 label=pool.describe(),
                                 _premerged=premerged))
    return out


def summarize(results: Sequence[RunResult]) -> str:
    lines = [f"{'label':<28}{'policy':<8}{'makespan_s':>12}{'mean_util':>10}"
             f"{'energy_kJ':>11}  split"]
    for r in results:
        lines.append(f"{r.label:<28}{r.policy:<8}{r.makespan:>12.1f}"
                     f"{r.mean_utilization:>10.3f}{r.total_energy/1e3:>11.1f}"
                     f"  {r.location_split}")
    return "\n".join(lines)
