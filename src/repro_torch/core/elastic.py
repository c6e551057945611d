# fmt: off
# A copy of src/repro/core/elastic.py with `reshard` ported to DTensor and
# without the jax imports, kept in its hand-aligned layout so the two stay
# diffable line for line; only the imports name repro_torch.
"""Elastic scaling, failure handling, straggler mitigation (JITA-4DS
"continuous provisioning and re-provisioning of DC resources").

Three mechanisms, sized for 1000+ node deployments:

  * :func:`reshard` — move a live pytree onto a different mesh/sharding
    (elastic scale up/down without a checkpoint round-trip). All-gather +
    re-place semantics; at scale this lowers to XLA resharding collectives.
  * :class:`HealthMonitor` — per-worker step-time EWMA; flags stragglers
    (> ``threshold`` × fleet median) and dead workers (missed heartbeats).
    The trainer consults it every step; mitigation = drop/replace the slow
    worker and re-mesh (the backup-task pattern, MapReduce-style, applied
    to synchronous data parallelism).
  * :class:`ElasticPlan` — given a pool size and a failure report, choose
    the next mesh shape (largest (data × model) grid that fits the healthy
    worker count while keeping the model axis intact).

The discrete-event side (failure *injection*, restart cost accounting) is
in repro.train.fault_tolerance; this module is the decision logic, kept
pure for property testing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor


# ---------------------------------------------------------------------------
# Live resharding
# ---------------------------------------------------------------------------

def reshard(tree, new_mesh: DeviceMesh, spec_fn) -> object:
    """Re-place every leaf of ``tree`` onto ``new_mesh``.

    ``spec_fn(leaf) -> PartitionSpec`` maps each leaf to its spec on the
    new mesh (normally repro_torch.distributed.sharding rules); the leaf
    becomes a DTensor with that spec's placements (``distribute_tensor``
    from rank 0's value). A DTensor leaf is gathered from its old mesh
    first, so this works across different device counts — the elastic
    scale-up/down primitive.
    """
    from repro_torch.distributed.sharding import placements
    from repro_torch.train.tree import tree_map

    def _move(leaf):
        spec = spec_fn(leaf)
        full = leaf.full_tensor() if isinstance(leaf, DTensor) else torch.as_tensor(leaf)
        full = full.to(new_mesh.device_type)
        return distribute_tensor(full, new_mesh, placements(spec, new_mesh, full.ndim))
    return tree_map(_move, tree)


# ---------------------------------------------------------------------------
# Health monitoring / straggler detection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkerHealth:
    worker: str
    ewma_step_s: float = 0.0
    last_heartbeat: float = 0.0
    steps: int = 0
    alive: bool = True


class HealthMonitor:
    """Tracks per-worker step times + heartbeats; flags stragglers/failures.

    Straggler rule (Dean's tail-at-scale guidance): a worker whose EWMA
    step time exceeds ``threshold`` × fleet median for ≥ ``patience``
    consecutive observations. Dead rule: no heartbeat for
    ``heartbeat_timeout`` seconds.
    """

    def __init__(self, workers: Sequence[str], alpha: float = 0.3,
                 threshold: float = 1.5, patience: int = 3,
                 heartbeat_timeout: float = 60.0, now: float = 0.0) -> None:
        # joining counts as a heartbeat: a worker that never reported gets
        # its grace period from ``now`` (the monitor's start time), not
        # from t=0 — otherwise any monitor started at now > timeout flags
        # every quiet worker dead on the first sweep
        self.health: Dict[str, WorkerHealth] = {
            w: WorkerHealth(w, last_heartbeat=now) for w in workers}
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.heartbeat_timeout = heartbeat_timeout
        self._strikes: Dict[str, int] = {w: 0 for w in workers}

    def observe(self, worker: str, step_s: float, now: float) -> None:
        h = self.health[worker]
        h.ewma_step_s = (step_s if h.steps == 0
                         else self.alpha * step_s + (1 - self.alpha) * h.ewma_step_s)
        h.steps += 1
        h.last_heartbeat = now
        # strike accounting lives here — exactly one strike decision per
        # observation, against the fleet median at observation time.
        # Polling stragglers() between observations can neither
        # double-count (it is a pure read) nor miss batched slow
        # observations (each is judged as it arrives).
        if h.alive:
            med = self._median()
            if med > 0:
                if h.ewma_step_s > self.threshold * med:
                    self._strikes[worker] += 1
                else:
                    self._strikes[worker] = 0

    def heartbeat(self, worker: str, now: float) -> None:
        self.health[worker].last_heartbeat = now

    def _median(self) -> float:
        ts = [h.ewma_step_s for h in self.health.values()  # det: ok np.median is order-independent
              if h.alive and h.steps > 0]
        return float(np.median(ts)) if ts else 0.0

    def stragglers(self) -> List[str]:
        """Workers over ``threshold`` × fleet median for ≥ ``patience``
        consecutive *observations*. Strikes are accounted in
        :meth:`observe`; this method is a pure read and can be called any
        number of times between observations."""
        return [w for w, h in self.health.items()  # det: ok registration order is the documented verdict order
                if h.alive and h.steps > 0
                and self._strikes[w] >= self.patience]

    def dead(self, now: float) -> List[str]:
        return [w for w, h in self.health.items()  # det: ok registration order is the documented verdict order
                if h.alive and now - h.last_heartbeat > self.heartbeat_timeout]

    def sweep_dead(self, now: float) -> List[str]:
        """Convict heartbeat-dead workers: :meth:`dead` + :meth:`mark_dead`
        in one step, returning the newly convicted names. Callers that
        only consulted :meth:`healthy` (``prune_pool``) used to miss
        workers that timed out but were never explicitly ``mark_dead``-ed;
        sweeping first closes that gap."""
        out = self.dead(now)
        for w in out:
            self.mark_dead(w)
        return out

    def mark_dead(self, worker: str) -> None:
        self.health[worker].alive = False
        # stale strikes must not survive exclusion: a worker rotated out
        # as a straggler would otherwise be re-convicted instantly on
        # rejoin, before a single fresh observation
        self._strikes[worker] = 0

    def mark_alive(self, worker: str, now: Optional[float] = None) -> None:
        """Proper rejoin: revive the worker with a clean slate — no stale
        strikes, EWMA restarted from the next observation, and (when
        ``now`` is given) a fresh heartbeat so the rejoin is not instantly
        swept dead again."""
        h = self.health[worker]
        h.alive = True
        h.steps = 0
        h.ewma_step_s = 0.0
        if now is not None:
            h.last_heartbeat = now
        self._strikes[worker] = 0

    def healthy(self) -> List[str]:
        return [w for w, h in self.health.items() if h.alive]  # det: ok registration order is the documented verdict order


def prune_pool(pool, monitor: "HealthMonitor",
               also_drop: Sequence[str] = (),
               now: Optional[float] = None):
    """Scheduler-side mitigation: the surviving :class:`ResourcePool` after
    dropping the monitor's dead workers (worker ids are PE names) plus any
    explicitly named PEs — typically ``monitor.stragglers()``, so slow
    workers can be rotated out before they miss heartbeats.

    Pass ``now`` to sweep heartbeat-dead workers first
    (:meth:`HealthMonitor.sweep_dead`) — without the sweep, workers that
    timed out but were never explicitly ``mark_dead``-ed still count as
    healthy and survive the prune.

    Feed the result to ``OnlineDriver.repool`` (repro.core.online) so the
    live scheduling engine re-plans onto the surviving PEs without a full
    restart — the JITA loop of "continuous provisioning and
    re-provisioning" closed over the workload manager. Scheduler state
    that is *workload*-scoped (placed history by location, per-instance
    VoS value curves) survives the re-plan; only pool-derived state is
    re-keyed.

    Site-aware pruning: when the pool carries federation metadata
    (``pool.site_of``, attached by
    :meth:`repro.core.federation.FederatedPool.flatten`) and *every* PE of
    a site is being dropped, the site's cross-site (WAN) links are pruned
    with it in the same repool — a fully-convicted edge box takes its
    uplink along instead of leaving a dangling channel to nowhere. Flat
    pools (no ``site_of``) deliberately keep all links: the data-home
    upload link must survive even when every data-home PE is removed,
    because surviving plans still route raw-input uploads over it —
    only explicit site metadata makes link-dropping safe."""
    if now is not None:
        monitor.sweep_dead(now)
    healthy = set(monitor.healthy()) - set(also_drop)
    pruned = pool.subset(p.name for p in pool.pes if p.name in healthy)
    site_of = getattr(pool, "site_of", None)
    if site_of:
        sites_before = {site_of[p.location] for p in pool.pes
                        if p.location in site_of}
        sites_after = {site_of[p.location] for p in pruned.pes
                       if p.location in site_of}
        gone = sites_before - sites_after
        if gone:
            dead_locs = {loc for loc, s in site_of.items() if s in gone}  # det: ok builds a set; membership only
            drop_keys = [
                (src, dst) for (src, dst) in pruned._links
                if (src in dead_locs or dst in dead_locs)
                and site_of.get(src) != site_of.get(dst)]
            if drop_keys:
                pruned = pruned.without_links(drop_keys)
    return pruned


# ---------------------------------------------------------------------------
# Elastic planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Next mesh decision after a capacity change."""

    mesh_shape: Dict[str, int]
    dropped: Tuple[str, ...]
    action: str  # "keep" | "shrink" | "grow"

    @property
    def n_devices(self) -> int:
        return int(np.prod(list(self.mesh_shape.values())))


def plan_remesh(healthy_devices: int, model_axis: int,
                current_data_axis: int,
                allow_grow: bool = True) -> ElasticPlan:
    """Choose the next (data, model) grid for ``healthy_devices``.

    The model axis is load-bearing (weights are sharded over it) so it is
    preserved; the data axis shrinks/grows to the largest multiple that
    fits. Requires healthy_devices >= model_axis (else the job must restart
    from checkpoint on a smaller model axis — caller's decision).
    """
    if healthy_devices < model_axis:
        raise ValueError(
            f"only {healthy_devices} healthy devices < model axis "
            f"{model_axis}; restart from checkpoint with a smaller mesh")
    data = max(healthy_devices // model_axis, 1)
    if not allow_grow:
        data = min(data, current_data_axis)
    action = ("keep" if data == current_data_axis
              else "shrink" if data < current_data_axis else "grow")
    return ElasticPlan({"data": data, "model": model_axis}, (), action)


def rebalance_batch(global_batch: int, data_axis: int) -> Tuple[int, int]:
    """Per-replica batch + padding after an elastic re-mesh.

    Keeps the *global* batch (and thus the loss scale / LR schedule)
    constant across re-meshes by padding to the next multiple; returns
    (per_replica, padded_global).
    """
    per = -(-global_batch // data_axis)  # ceil
    return per, per * data_axis
