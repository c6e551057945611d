# fmt: off
# A copy of src/repro/serve/gateway.py, kept in its hand-aligned layout so the
# two stay diffable line for line; only the imports name repro_torch.
"""SLO-aware serving gateway: the online driver in front of the serve engine.

The paper's whole point is just-in-time resource management *for live
workloads* (PAPER §VoS, §VDC) — this module closes the loop between the
scheduler core and the continuous-batching LM serving engine:

  request (:class:`~repro.serve.engine.RequestSpec`, serving *tier*)
    → per-request :class:`~repro.core.vos.ValueCurve`
      (:func:`repro.core.vos.tier_curve`, shifted to the arrival so the
      SLO clock starts when the request does)
    → two-task pipeline instance (prefill → decode,
      :func:`repro.pipeline.workloads.inference_request_pipeline`)
    → :class:`~repro.core.online.OnlineDriver` admission gate — the
      floor-ordered gate *is* the tiered admission control: interactive
      floors sit below batch below best-effort, so higher tiers admit
      first without any gateway-side queueing logic
    → value-aware overload control: when the booked-ahead backlog
      (:meth:`OnlineDriver.backlog`) passes the shed horizon,
      ``shed_pending`` drops the lowest-value pending work
      (best-effort first); interactive arrivals into a deep backlog go
      through ``admit_preempting`` and may displace in-flight
      best-effort work
    → the planned schedule replayed into the continuous-batching
      :class:`~repro.serve.engine.ServeEngine` (:meth:`ServingGateway.serve`).

Cost-model bridge: the serving pool is one PE per decode slot;
:func:`token_work_rates` picks per-token work units so that
``CostModel.exec_time`` on a slot equals the serve engine's abstract
per-token costs (``prefill_cost_per_tok``/``decode_cost_per_tok``) — one
number space for the gateway's planner and the execution backend's clock.

Determinism and restart: everything downstream of a fixed request trace is
deterministic (seeded trace synthesis, deterministic driver), and
:meth:`ServingGateway.snapshot` / :meth:`ServingGateway.restore` round the
gateway through the online driver's durable record
(:func:`repro.core.online.restart_from_history`) — a restored gateway
continues the trace byte-identically (pinned in tests/test_serve.py and
gated in benchmarks/bench_gateway.py).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_model import CostModel
from repro_torch.core.online import OnlineDriver, restart_from_history
from repro_torch.core.resources import ProcessingElement, ResourcePool
from repro_torch.core.schedulers import assignment_digest
from repro_torch.core.vos import TIERS, ValueCurve, tier_curve
from repro_torch.pipeline.workloads import inference_request_pipeline
from repro_torch.serve.engine import EngineConfig, RequestSpec, ServeEngine


def serve_pool(n_slots: int = 8, kind: str = "v100", location: str = "dc",
               speed: float = 1.0, power_busy: float = 300.0,
               power_idle: float = 60.0) -> ResourcePool:
    """The serving pool: one PE per decode slot, single location, no
    links — the gateway's planning twin of the serve engine's
    ``max_batch`` KV-cache slots."""
    return ResourcePool([
        ProcessingElement(f"slot{j}", kind, location=location, speed=speed,
                          power_busy=power_busy, power_idle=power_idle)
        for j in range(n_slots)])


def serve_cost_model() -> CostModel:
    """Cost model for the serving pool. Requests carry no raw input bytes
    (``in_bytes=0`` in the request pipeline), so data-gravity upload
    charges never apply and the defaults are exact."""
    return CostModel()


def token_work_rates(ecfg: EngineConfig, cost: CostModel,
                     pool: ResourcePool) -> Tuple[float, float]:
    """``(prefill, decode)`` work units per token such that the cost
    model's exec time on the pool's serving slots equals the serve
    engine's abstract per-token costs: ``exec = work / (rate·speed)``, so
    ``work_per_tok = cost_per_tok · rate · speed`` makes
    ``exec = tokens · cost_per_tok`` — the cost-model bridge."""
    if not pool.pes:
        raise ValueError("empty serving pool")
    k0 = (pool.pes[0].kind, pool.pes[0].speed)
    if any((p.kind, p.speed) != k0 for p in pool.pes):
        raise ValueError(
            "the token-cost bridge needs a homogeneous serving pool "
            "(one kind/speed — heterogeneous pools have no single "
            "per-token cost)")
    rate = cost.rate["ml"][k0[0]] * k0[1]
    return (ecfg.prefill_cost_per_tok * rate, ecfg.decode_cost_per_tok * rate)


@dataclasses.dataclass(frozen=True)
class GatewayConfig:
    """Gateway knobs. ``slo_unit`` rescales the whole tier ladder
    (:func:`repro.core.vos.tier_curve`) to the deployment's service-time
    scale; the backlog horizons are in simulated seconds of booked-ahead
    work per slot (:meth:`repro.core.online.OnlineDriver.backlog`)."""

    policy: str = "vos"            # admission needs per-instance floors
    slo_unit: float = 2.0          # seconds per tier latency-budget unit
    #: arrival-shift quantisation: > 0 floors each request's curve shift
    #: to a multiple, so a quantum's arrivals share one shifted curve per
    #: tier (shared candidate classes). Strict-side approximation — keep
    #: it well under the interactive soft deadline. 0 = exact shifts
    #: (bursts still share: same-instant arrivals share a curve).
    slo_quantum: float = 0.0
    window_s: float = 10.0         # arrival window; the driver drains once per window
    shed_backlog_s: float = 60.0   # mean booked-ahead seconds that triggers shedding
    preempt: bool = True
    preempt_backlog_s: float = 20.0  # min max-backlog before an interactive arrival probes
    preempt_margin: float = 0.0
    #: an admit_preempting probe costs O(assignment history): the victim
    #: scan walks the whole booked schedule, and a *displacing* admission
    #: re-prices the victim via lineage invalidation + trusted replay
    #: (the PR-6/9 recovery path, priced for rare events)
    max_preempt_probes_per_window: int = 1
    #: minimum simulated seconds between preempt probes, on top of the
    #: per-window cap. The window cap alone makes the probe rate scale
    #: with 1/window_s, which is quadratic over a long trace (each probe
    #: replays a growing history); a sim-time interval decouples the
    #: preemption budget from the shed control loop's cadence, so
    #: windows can stay tight without unbounded preemption work
    #: (bench_gateway's scale tier: 5 s windows, 600 s probe interval).
    #: 0 = no interval (smoke-scale traces)
    preempt_min_interval_s: float = 0.0
    energy_weight: float = 0.0     # >= 0 keeps the admission gate deferrable
    ecfg: EngineConfig = dataclasses.field(default_factory=EngineConfig)


@dataclasses.dataclass
class GatewayReport:
    """Per-run serving metrics. ``goodput`` is realised / offered value
    (each request offers its curve's value at its own arrival; completing
    inside the flat region realises all of it); ``attained`` counts
    completions with nonzero value at finish (best-effort never expires,
    so for it attained = completed); ``digest`` is the schedule
    fingerprint the golden gate and the restart differential compare."""

    n_requests: int
    n_completed: int
    n_shed: int
    n_preemptions: int
    n_displaced: int
    n_events: int
    makespan: float
    goodput: float
    shed_rate: float
    per_tier: Dict[str, Dict[str, float]]
    digest: str
    wall_seconds: float = 0.0


class ServingGateway:
    """Maps a request stream onto the online driver (see module docstring).

    Feed arrivals in nondecreasing time order via :meth:`offer` (or
    :meth:`run` for a whole trace); the gateway processes them in
    ``window_s`` arrival windows — at each window boundary it checks the
    booked backlog, sheds the lowest-value pending work if over the
    horizon, and drains the driver. :meth:`drain` closes the last window;
    :meth:`report` summarises; :meth:`snapshot`/:meth:`restore` round
    through the durable record.
    """

    def __init__(self, gcfg: Optional[GatewayConfig] = None,
                 pool: Optional[ResourcePool] = None,
                 cost: Optional[CostModel] = None,
                 sanitize: Optional[bool] = None,
                 driver: Optional[OnlineDriver] = None) -> None:
        self.gcfg = gcfg or GatewayConfig()
        self.pool = pool or serve_pool(self.gcfg.ecfg.max_batch)
        self.cost = cost or serve_cost_model()
        self._w_prefill, self._w_decode = token_work_rates(
            self.gcfg.ecfg, self.cost, self.pool)
        if driver is None:
            driver = OnlineDriver(self.pool, self.cost,
                                  policy=self.gcfg.policy,
                                  sanitize=sanitize,
                                  energy_weight=self.gcfg.energy_weight)
        self.drv = driver
        self.specs: Dict[int, RequestSpec] = {}
        self._tier_curves: Dict[Tuple[str, float], ValueCurve] = {}
        self._window: Optional[int] = None
        self._probes_left = self.gcfg.max_preempt_probes_per_window
        self._next_probe_t = -math.inf
        self._last_arrival = -math.inf

    # -- admission ---------------------------------------------------------------
    def _resolve_curve(self, spec: RequestSpec) -> ValueCurve:
        """The request's SLO curve with its clock started at arrival: the
        caller's own curve if given, else the tier's canonical shape,
        shifted by the (optionally quantised) arrival time."""
        dt = float(spec.arrival)
        q = self.gcfg.slo_quantum
        if q > 0:
            dt = math.floor(dt / q) * q
        if spec.curve is not None:
            return spec.curve.shifted(dt)
        key = (spec.tier, dt)
        c = self._tier_curves.get(key)
        if c is None:
            c = tier_curve(spec.tier, self.gcfg.slo_unit).shifted(dt)
            self._tier_curves[key] = c
        return c

    def offer(self, spec: RequestSpec) -> None:
        """Feed one arrival (nondecreasing arrival order)."""
        t = float(spec.arrival)
        if t < self._last_arrival:
            raise ValueError("offers must arrive in nondecreasing time "
                             f"order (got {t} after {self._last_arrival})")
        self._last_arrival = t
        w = int(t // self.gcfg.window_s)
        if self._window is None:
            self._window = w
        elif w > self._window:
            self._close_window()
            self._window = w
        if spec.rid in self.specs:
            raise ValueError(f"duplicate rid {spec.rid}")
        self.specs[spec.rid] = spec
        curve = self._resolve_curve(spec)
        dag = inference_request_pipeline(
            spec.rid, spec.prompt_len, spec.max_new_tokens,
            prefill_work_per_tok=self._w_prefill,
            decode_work_per_tok=self._w_decode)
        gcfg = self.gcfg
        if (gcfg.preempt and spec.tier == "interactive"
                and self._probes_left > 0 and t >= self._next_probe_t):
            _mean, mx = self.drv.backlog(t)
            if mx >= gcfg.preempt_backlog_s:
                self._probes_left -= 1
                self._next_probe_t = t + gcfg.preempt_min_interval_s
                self.drv.admit_preempting(dag, t, curve=curve,
                                          margin=gcfg.preempt_margin)
                return
        self.drv.submit(dag, t, curve=curve)

    # -- window boundary ---------------------------------------------------------
    def _shed_overload(self, t: float) -> None:
        """Value-aware load shedding: when the mean booked-ahead backlog
        exceeds the shed horizon by a factor f, drop the (1 - 1/f)
        fraction of pending work with the largest value floors — under
        the tier curves that is best-effort first, then the stalest
        batch work, and interactive last."""
        gcfg = self.gcfg
        if gcfg.shed_backlog_s <= 0 or not self.drv.pending:
            return
        mean, _mx = self.drv.backlog(t)
        if mean <= gcfg.shed_backlog_s:
            return
        overload = mean / gcfg.shed_backlog_s
        k = min(self.drv.pending,
                math.ceil(self.drv.pending * (1.0 - 1.0 / overload)))
        if k > 0:
            self.drv.shed_pending(k)

    def _close_window(self) -> None:
        t_end = (self._window + 1) * self.gcfg.window_s
        self._shed_overload(t_end)
        drv = self.drv
        # inline drain (not drv.run()): the final whole-schedule sanitizer
        # pass runs once at drain(), not once per window
        while not (drv.step() is None and not drv.pending):
            pass
        self._probes_left = self.gcfg.max_preempt_probes_per_window

    def sync(self) -> None:
        """Close the open arrival window (shed check + full drain) — the
        gateway's quiescent point; :meth:`snapshot` implies it. Idempotent:
        a second close of the same window is a no-op, which is what makes
        snapshot-at-a-boundary byte-identical to running straight through."""
        if self._window is not None:
            self._close_window()

    def drain(self) -> None:
        """Close the last window and run the driver to completion
        (including the sanitizer's final whole-schedule validation when
        enabled)."""
        self.sync()
        self.drv.run()

    # -- metrics -----------------------------------------------------------------
    def report(self, wall_seconds: float = 0.0) -> GatewayReport:
        drv = self.drv
        curves = drv.slo_curves()
        finish_of: Dict[str, float] = {}
        for name, f in drv.completions:
            finish_of[name] = f
        dropped = set(drv.shed_instances) | set(drv.cancelled_instances)
        per_tier: Dict[str, Dict[str, float]] = {
            t: {"submitted": 0, "completed": 0, "shed": 0, "attained": 0,
                "offered_value": 0.0, "realized_value": 0.0}
            for t in TIERS}
        for rid in sorted(self.specs):
            spec = self.specs[rid]
            row = per_tier[spec.tier]
            row["submitted"] += 1
            c = curves.get(str(rid))
            peak = c.value(float(spec.arrival)) if c is not None else 1.0
            row["offered_value"] += peak
            if f"req{rid}" in dropped:
                row["shed"] += 1
                continue
            f = finish_of.get(f"req{rid}")
            if f is None:
                continue
            row["completed"] += 1
            v = c.value(f) if c is not None else peak
            row["realized_value"] += v
            if v > 0.0:
                row["attained"] += 1
        offered = realized = 0.0
        n_completed = n_shed = 0
        for t in TIERS:
            row = per_tier[t]
            offered += row["offered_value"]
            realized += row["realized_value"]
            n_completed += row["completed"]
            n_shed += row["shed"]
            row["attainment"] = row["attained"] / max(row["submitted"], 1)
        n = len(self.specs)
        makespan = max((f for _nm, f in drv.completions), default=0.0)
        return GatewayReport(
            n_requests=n, n_completed=n_completed, n_shed=n_shed,
            n_preemptions=drv.n_preemptions, n_displaced=drv.n_displaced,
            n_events=drv.n_events, makespan=makespan,
            goodput=realized / max(offered, 1e-12),
            shed_rate=n_shed / max(n, 1),
            per_tier=per_tier,
            digest=assignment_digest(drv.eng.assignments),
            wall_seconds=wall_seconds)

    def run(self, specs: Sequence[RequestSpec]) -> GatewayReport:
        """Offer a whole trace, drain, report."""
        t0 = time.perf_counter()
        for s in specs:
            self.offer(s)
        self.drain()
        return self.report(wall_seconds=time.perf_counter() - t0)

    # -- durable record ----------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """The gateway's durable record at a window boundary (implies
        :meth:`sync`): the driver's durable record — admitted instances,
        assignment history, pending submissions, curve map, locations,
        retry floors, cancellations, horizon events — plus the request
        table and gateway cursor. Everything :meth:`restore` needs to
        rebuild a gateway whose continuation of the trace is
        byte-identical."""
        self.sync()
        drv = self.drv
        return {
            "admitted": [(inst.dag, inst.arrival) for inst in drv.instances],
            "history": list(drv.eng.assignments),
            "pending": drv.pending_submissions(),
            "curves": drv.slo_curves(),
            "loc_of": dict(drv._loc_of),
            "retry_floors": dict(drv.retry_floors),
            "cancelled": list(drv.cancelled_instances),
            "horizon_events": [tuple(e) for e in drv.horizon_events],
            "shed": list(drv.shed_instances),
            "n_preemptions": drv.n_preemptions,
            "n_displaced": drv.n_displaced,
            "specs": dict(self.specs),
            "window": self._window,
            "last_arrival": self._last_arrival,
            "probes_left": self._probes_left,
            "next_probe_t": self._next_probe_t,
        }

    @classmethod
    def restore(cls, snap: Dict[str, object],
                gcfg: Optional[GatewayConfig] = None,
                pool: Optional[ResourcePool] = None,
                cost: Optional[CostModel] = None,
                sanitize: Optional[bool] = None) -> "ServingGateway":
        """Rebuild a gateway from :meth:`snapshot` via
        :func:`repro.core.online.restart_from_history`."""
        gcfg = gcfg or GatewayConfig()
        pool = pool or serve_pool(gcfg.ecfg.max_batch)
        cost = cost or serve_cost_model()
        drv = restart_from_history(
            pool, cost, gcfg.policy,
            snap["admitted"], snap["history"], pending=snap["pending"],
            loc_of=snap["loc_of"], retry_floors=snap["retry_floors"],
            cancelled=snap["cancelled"],
            horizon_events=snap["horizon_events"],
            sanitize=sanitize, energy_weight=gcfg.energy_weight,
            curves=snap["curves"])
        drv.shed_instances = list(snap["shed"])
        drv.n_preemptions = int(snap["n_preemptions"])
        drv.n_displaced = int(snap["n_displaced"])
        gw = cls(gcfg=gcfg, pool=pool, cost=cost, driver=drv)
        gw.specs = dict(snap["specs"])
        gw._window = snap["window"]
        gw._last_arrival = float(snap["last_arrival"])
        gw._probes_left = int(snap["probes_left"])
        gw._next_probe_t = float(snap["next_probe_t"])
        return gw

    # -- execution backend -------------------------------------------------------
    def plan_order(self) -> List[Tuple[float, int]]:
        """``(planned prefill start, rid)`` for every request the plan
        kept (shed/cancelled excluded), in planned admission order — the
        order :meth:`serve` replays into the engine. A preempted-and-
        resumed request counts at its final placement."""
        dropped = set(self.drv.shed_instances) | \
            set(self.drv.cancelled_instances)
        start_of: Dict[int, float] = {}
        for a in self.drv.eng.assignments:
            if not a.task.startswith("prefill#"):
                continue
            rid = int(a.task.split("#", 1)[1])
            if f"req{rid}" in dropped:
                continue
            start_of[rid] = a.start  # last placement wins (preemption)
        return sorted(
            (start, rid)
            for rid, start in start_of.items())  # det: ok sorted() consumes it

    def serve(self, engine: ServeEngine, max_ticks: int = 100000
              ) -> Dict[str, float]:
        """Execute the plan on the continuous-batching serve engine:
        requests enter in planned admission order (``fcfs`` over
        plan-order arrival ranks — simulated time lives in the gateway's
        plan; the engine clock is the abstract per-token one). Requests
        must carry real prompt token arrays. Returns the engine's
        ``latency_stats()``."""
        if engine.ecfg.policy != "fcfs":
            raise ValueError(
                "serve() replays the gateway's admission order; build the "
                "engine with EngineConfig(policy='fcfs')")
        for i, (_start, rid) in enumerate(self.plan_order()):
            spec = self.specs[rid]
            engine.submit(RequestSpec(
                rid=rid, prompt=spec.prompt,
                max_new_tokens=spec.max_new_tokens, arrival=float(i),
                tier=spec.tier, curve=spec.curve))
        engine.run(max_ticks=max_ticks)
        return engine.latency_stats()


def synth_requests(n: int, seed: int = 0, mean_gap: float = 0.05,
                   alpha: float = 1.5, max_burst: int = 64,
                   day_s: float = 86400.0, diurnal_depth: float = 0.7,
                   tier_shares: Tuple[float, float, float] = (0.25, 0.45,
                                                              0.30),
                   prompt_buckets: Sequence[int] = (32, 64, 128, 256),
                   decode_buckets: Sequence[int] = (16, 64, 192)
                   ) -> List[RequestSpec]:
    """Heavy-tailed bursty + diurnal request trace, deterministic per seed.

    The arrival process is bench_online's bursty shape — Zipf(2) burst
    sizes × Pareto(``alpha``) gaps — with the gap rate modulated by a
    sinusoidal diurnal profile (peak/trough rate ratio
    ``(1+depth)/(1-depth)``). Tiers are drawn from ``tier_shares``
    (interactive/batch/best-effort); prompt and decode lengths come from
    small padding-bucket sets, the way a real serving stack pads — which
    also keeps cost rows shared, so the planner's candidate classes stay
    few. Prompts are bare token counts (scheduling-only specs);
    interactive requests decode the short bucket (chat-style answers).
    """
    rng = np.random.default_rng(seed)
    p = np.asarray(tier_shares, dtype=float)
    p = p / p.sum()
    out: List[RequestSpec] = []
    t = 0.0
    while len(out) < n:
        burst = int(min(rng.zipf(2.0), max_burst))
        gap = mean_gap * (rng.pareto(alpha) + 0.1)
        rate = 1.0 + diurnal_depth * math.sin(2.0 * math.pi * t / day_s)
        t += gap / max(rate, 1e-9)
        for _ in range(burst):
            if len(out) >= n:
                break
            tier = TIERS[int(rng.choice(len(TIERS), p=p))]
            dec = (decode_buckets[0] if tier == "interactive"
                   else int(rng.choice(decode_buckets)))
            out.append(RequestSpec(
                rid=len(out), prompt=int(rng.choice(prompt_buckets)),
                max_new_tokens=dec, arrival=t, tier=tier))
    return out
