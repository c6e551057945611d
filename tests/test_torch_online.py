"""The port's online scheduling core vs live runs of the reference.

``repro_torch.core.{online, simulator, recovery, preemption, federation,
schedulers_reference}`` are copies of the reference modules and
``repro_torch.core.elastic`` is the framework-free part of
``repro.core.elastic``. Each scenario below mirrors one of
``tests/test_online.py``, ``test_recovery.py``, ``test_federation.py``,
``test_partition.py``, ``test_chaos.py`` and ``test_vdc_elastic.py``; it
runs once on each package, and the two results must be equal byte for
byte (``repr`` of every placement's floats, reports and counters;
``wall_seconds`` is telemetry and left out). Where the reference test
checks a property of one package (online equals batch, live recovery
equals a restart from history), the scenario checks it on both. Nothing
here reads the checked-in goldens: some of them fail in the reference
itself on this machine, so the oracle is the live reference run.
"""

import importlib
import inspect
import re
import types
from pathlib import Path

import numpy as np
import pytest

CORE = (
    "cost_model",
    "dag",
    "elastic",
    "federation",
    "online",
    "preemption",
    "recovery",
    "resources",
    "schedulers",
    "schedulers_reference",
    "simulator",
    "vos",
)


def _package(root):
    mods = {m: importlib.import_module(f"{root}.core.{m}") for m in CORE}
    mods["workloads"] = importlib.import_module(f"{root}.pipeline.workloads")
    return types.SimpleNamespace(**mods)


REF = _package("repro")
PORT = _package("repro_torch")
POLICIES = REF.schedulers.POLICIES
SRC = Path(__file__).resolve().parent.parent / "src"


def _both(scenario, *args):
    """The scenario's result on the reference and on the port, as reprs."""
    ref, port = (repr(scenario(P, *args)) for P in (REF, PORT))
    return ref, port


def _tuples(sched):
    return [
        (a.task, a.op, a.pe, a.start, a.finish, a.comm_wait, a.energy)
        for a in sched.assignments
    ]


def _template(P, seed, n=8, name="tpl"):
    """The random template of the reference tests, from numpy's rng."""
    rng = np.random.default_rng(seed)
    ops = ["ingest", "sql_transform", "kmeans", "summarize", "window_agg",
           "linreg", "anomaly", "export"]
    g = P.dag.PipelineDAG(f"{name}{seed}")
    for i in range(n):
        g.add_task(P.dag.Task(
            f"t{i}", str(rng.choice(ops)), work=float(rng.uniform(0.5, 12)),
            out_bytes=float(rng.uniform(0, 3e6)),
            in_bytes=float(rng.uniform(0, 6e6)) if i == 0 else 0))
    for i in range(1, n):
        for j in rng.choice(i, size=min(i, 2), replace=False):
            g.add_edge(f"t{j}", f"t{i}")
    return g


def _record(drv):
    """The driver's durable record, as restart_from_history takes it."""
    return dict(
        admitted=[(inst.dag, inst.arrival) for inst in drv.instances],
        history=list(drv.eng.assignments),
        pending=drv.pending_submissions(),
        loc_of=dict(drv._loc_of),
        retry_floors=dict(drv.retry_floors),
        cancelled=list(drv.cancelled_instances),
        horizon_events=list(drv.horizon_events),
    )


def _restart(P, pool, cost, policy, rec, **kw):
    return P.online.restart_from_history(
        pool, cost, policy, rec["admitted"], rec["history"], rec["pending"],
        rec["loc_of"], retry_floors=rec["retry_floors"],
        cancelled=rec["cancelled"], horizon_events=rec["horizon_events"], **kw)


def _run_result(r):
    """An OnlineRunResult's fields without the wall clock."""
    return (_tuples(r.schedule), r.makespan, r.total_energy, r.mean_utilization,
            r.n_events, r.max_live, list(r.completions), r.n_batched_steps)


# ---------------------------------------------------------------------------
# The copies themselves
# ---------------------------------------------------------------------------

_IMPORT = re.compile(r"^(\s*)(from|import) repro\.", re.M)
COPIED = ["core/preemption.py", "core/recovery.py", "core/federation.py",
          "core/simulator.py", "core/online.py", "core/schedulers_reference.py",
          "serve/gateway.py"]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_modules_equal_their_reference(rel):
    """Each copy is its reference module with the three-line header on top
    and ``repro.`` renamed to ``repro_torch.`` in import lines only."""
    ref = (SRC / "repro" / rel).read_text()
    header = (f"# fmt: off\n# A copy of src/repro/{rel}, kept in its hand-aligned "
              "layout so the\n# two stay diffable line for line; only the imports "
              "name repro_torch.\n")
    renamed = _IMPORT.sub(lambda m: f"{m.group(1)}{m.group(2)} repro_torch.", ref)
    assert (SRC / "repro_torch" / rel).read_text() == header + renamed


def test_elastic_copy_equals_its_reference_functions():
    """The port's elastic module is the reference's: the same source for
    each of its framework-free classes and functions, and a ``reshard``
    over DTensor that moves a tree as the reference's moves one onto the
    current devices (a one-rank mesh, a replicated spec)."""
    import torch
    import torch_dist_ranks as R
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import P

    names = ["WorkerHealth", "HealthMonitor", "prune_pool", "ElasticPlan",
             "plan_remesh", "rebalance_batch"]
    for name in names:
        ref = inspect.getsource(getattr(REF.elastic, name))
        assert inspect.getsource(getattr(PORT.elastic, name)) == ref, name
    tree = {"w": np.ones((4, 4), np.float32), "b": [np.arange(3, dtype=np.float32)]}
    with R.process_group("gloo", 1):
        out = PORT.elastic.reshard(tree, R.mesh((1, 1), ("data", "model")), lambda leaf: P())
        assert isinstance(out["w"], DTensor) and isinstance(out["b"][0], DTensor)
        assert float(out["w"].full_tensor().sum()) == 16
        assert torch.equal(out["b"][0].full_tensor(), torch.arange(3.0))
    text = (SRC / "repro_torch/core/elastic.py").read_text()
    assert "import jax" not in text and "from jax" not in text


def test_copied_workload_builders_equal_their_reference():
    for name in ("neubot_query_pipeline", "lm_training_pipeline",
                 "inference_request_pipeline"):
        ref = inspect.getsource(getattr(REF.workloads, name))
        assert inspect.getsource(getattr(PORT.workloads, name)) == ref, name


def _builders(P):
    out = []
    for g in (P.workloads.neubot_query_pipeline(),
              P.workloads.lm_training_pipeline("qwen3-0.6b"),
              P.workloads.inference_request_pipeline(7, 128, 64,
                                                     prefill_work_per_tok=0.5)):
        out.append((g.name, [(t.name, t.op, t.work, t.out_bytes, t.in_bytes,
                              t.params) for t in g.tasks],
                    [(t.name, [s.name for s in g.successors(t.name)]) for t in g.tasks]))
    return out


def test_workload_builders_match_reference():
    ref, port = _both(_builders)
    assert port == ref


# ---------------------------------------------------------------------------
# Batch equivalence and the online driver (tests/test_online.py)
# ---------------------------------------------------------------------------

def _online_vs_batch(P, policy, period):
    wl, pool, cost = P.workloads.ds_workload(), P.resources.paper_pool(), P.cost_model.CostModel()
    batch = P.simulator.run_instances(wl, pool, cost, policy=policy,
                                      n_instances=6, period=period)
    online = P.simulator.run_instances(wl, pool, cost, policy=policy,
                                       n_instances=6, period=period, online=True)
    assert _tuples(online.schedule) == _tuples(batch.schedule)
    assert online.n_events == len(batch.schedule.assignments)
    direct = P.online.run_online(wl, pool, cost, policy=policy, n_instances=6,
                                 period=period)
    return _tuples(batch.schedule), batch.makespan, _run_result(direct)


@pytest.mark.parametrize("period", [0.0, 3.0])
@pytest.mark.parametrize("policy", POLICIES)
def test_run_online_matches_reference_and_batch(policy, period):
    ref, port = _both(_online_vs_batch, policy, period)
    assert port == ref


def _split(P, policy, drop, k, n_instances=12, period=3.0, grow=False):
    wl, cost = P.workloads.ds_workload(), P.cost_model.CostModel()
    full = P.resources.paper_pool()
    pool = full.without(drop) if grow else full
    drv = P.online.OnlineDriver(pool, cost, policy=policy)
    for i in range(n_instances):
        drv.submit(wl.instance(i), arrival_t=i * period)
    for _ in range(k):
        assert drv.step() is not None
    rec = _record(drv)
    rec["loc_of"] = {p.name: p.location for p in pool.pes}
    new_pool = full if grow else pool.without(drop)
    drv.repool(new_pool)
    a = _tuples(drv.run())
    b = _tuples(_restart(P, new_pool, cost, policy, rec).run())
    assert a == b
    return a


@pytest.mark.parametrize("policy", POLICIES)
def test_repool_shrink_matches_restart_and_reference(policy):
    ref, port = _both(_split, policy, ["xeon2", "arm1"], 50)
    assert port == ref


@pytest.mark.parametrize("policy", ["eft", "vos"])
def test_repool_whole_location_removed_matches_reference(policy):
    ref, port = _both(_split, policy, ["arm0", "arm1", "arm2", "volta0"], 64)
    assert port == ref


@pytest.mark.parametrize("policy", ["etf_hwang", "heft"])
def test_repool_grow_matches_reference(policy):
    ref, port = _both(_split, policy, ["xeon2"], 40, 10, 3.0, True)
    assert port == ref


def _health_repool(P):
    wl, pool = P.workloads.ds_workload(), P.resources.paper_pool()
    drv = P.online.OnlineDriver(pool, P.cost_model.CostModel(), policy="eft")
    for i in range(6):
        drv.submit(wl.instance(i), arrival_t=0.0)
    for _ in range(30):
        drv.step()
    mon = P.elastic.HealthMonitor([p.name for p in pool.pes], heartbeat_timeout=5.0)
    for p in pool.pes:
        mon.heartbeat(p.name, now=8.0)
    mon.heartbeat("xeon1", now=-100.0)
    for w in mon.dead(now=10.0):
        mon.mark_dead(w)
    n_before = len(drv.eng.assignments)
    drv.repool(P.elastic.prune_pool(pool, mon))
    sched = drv.run()
    assert all(a.pe != "xeon1" for a in sched.assignments[n_before:])
    return mon.healthy(), _tuples(sched)


def test_health_monitor_drives_repool_as_reference():
    ref, port = _both(_health_repool)
    assert port == ref


def _bursty(P, policy):
    """Bursty coincident arrivals through the batched gate, and the
    heterogeneous submissions of random templates."""
    wl, cost = P.workloads.ds_workload(), P.cost_model.CostModel()
    rng = np.random.default_rng(5)
    ts, t = [], 0.0
    while len(ts) < 10:
        t += 4.0 * (float(rng.pareto(1.5)) + 0.1)
        ts.extend([t] * int(min(rng.zipf(2.0), 6)))
    drv = P.online.OnlineDriver(P.resources.paper_pool(), cost, policy=policy)
    for i, at in enumerate(ts[:10]):
        drv.submit(wl.instance(i), arrival_t=at)
    first = (_tuples(drv.run()), drv.n_batched_steps, drv.result().max_live)
    drv = P.online.OnlineDriver(P.resources.paper_pool(), cost, policy=policy)
    for i, seed in enumerate((1, 2, 3)):
        drv.submit(_template(P, seed, 9).instance(seed), arrival_t=i * 4.0)
    return first, _tuples(drv.run()), sorted(drv.completions)


@pytest.mark.parametrize("policy", POLICIES)
def test_batched_admission_matches_reference(policy):
    ref, port = _both(_bursty, policy)
    assert port == ref


def _stepwise(P):
    wl, pool, cost = P.workloads.ds_workload(), P.resources.paper_pool(), P.cost_model.CostModel()
    drv = P.online.OnlineDriver(pool, cost, policy="etf")
    for i in range(5):
        drv.submit(wl.instance(i), arrival_t=i * 7.5)
    placed = []
    while True:
        a = drv.step()
        if a is None and not drv.pending:
            break
        placed.append((a.task, a.pe, a.start, a.finish))
    res = drv.result()
    return placed, res.makespan, res.policy, res.total_energy


def test_stepwise_driver_matches_reference():
    ref, port = _both(_stepwise)
    assert port == ref


# ---------------------------------------------------------------------------
# Failures, shedding, rejoin and health (tests/test_recovery.py)
# ---------------------------------------------------------------------------

def _fail_split(P, policy, dead=("xeon2", "arm1"), k=50, budget=3):
    wl, cost = P.workloads.ds_workload(), P.cost_model.CostModel()
    drv = P.online.OnlineDriver(P.resources.paper_pool(), cost, policy=policy)
    drv.retry = P.recovery.RetryState(budget=budget)
    for i in range(12):
        drv.submit(wl.instance(i), arrival_t=i * 3.0)
    for _ in range(k):
        assert drv.step() is not None
    t_fail = max(a.start for a in drv.eng.assignments)
    rep = drv.fail(t_fail, list(dead))
    rec = _record(drv)
    a = _tuples(drv.run())
    b = _tuples(_restart(P, drv.pool, cost, policy, rec).run())
    assert a == b and len({t[0] for t in a}) == 12 * 16
    res = drv.result()
    return (a, rep.lost, rep.survivors, rep.retry_floors, rep.dead_pes,
            res.n_failures, res.n_lost_tasks, res.lost_exec_seconds)


@pytest.mark.parametrize("policy", POLICIES)
def test_recovery_restart_from_history_matches_reference(policy):
    ref, port = _both(_fail_split, policy)
    assert port == ref


def _link_failure(P):
    wl, cost = P.workloads.ds_workload(), P.cost_model.CostModel()
    drv = P.online.OnlineDriver(P.resources.paper_pool(), cost, policy="eft")
    for i in range(6):
        drv.submit(wl.instance(i), arrival_t=i * 3.0)
    for _ in range(40):
        drv.step()
    riding = [a for a in drv.eng.assignments if a.comm_wait > 0]
    t = riding[len(riding) // 2].start + 1e-9
    rep = drv.fail(t, links=[("frontend", "backend"), ("backend", "frontend")])
    rec = _record(drv)
    a = _tuples(drv.run())
    assert a == _tuples(_restart(P, drv.pool, cost, "eft", rec).run())
    return rep.lost, a


def _retry_exhaustion(P):
    wl, cost = P.workloads.ds_workload(), P.cost_model.CostModel()
    drv = P.online.OnlineDriver(P.resources.paper_pool(), cost, policy="eft")
    drv.retry = P.recovery.RetryState(budget=1)
    for i in range(6):
        drv.submit(wl.instance(i), arrival_t=i * 3.0)
    for _ in range(40):
        drv.step()
    last = max(drv.eng.assignments, key=lambda a: a.start)
    r1 = drv.fail(last.start, [last.pe])
    target = r1.lost[0]
    while all(a.task != target for a in drv.eng.assignments):
        assert drv.step() is not None
    a2 = next(a for a in drv.eng.assignments if a.task == target)
    r2 = drv.fail(a2.start, [a2.pe])
    rec = _record(drv)
    a = _tuples(drv.run())
    assert a == _tuples(_restart(P, drv.pool, cost, "eft", rec).run())
    res = drv.result()
    return r1.lost, r2.lost, r2.cancelled, res.cancelled, res.n_lost_tasks, a


def _shed(P):
    wl = P.workloads.ds_workload()
    drv = P.online.OnlineDriver(P.resources.paper_pool(), P.cost_model.CostModel(),
                                policy="eft")
    for i in range(12):
        drv.submit(wl.instance(i), arrival_t=i * 40.0)
    for _ in range(30):
        drv.step()
    t = max(a.start for a in drv.eng.assignments)
    rep = drv.fail(t, ["xeon0", "xeon1", "xeon2"], shed="auto")
    sched = drv.run()
    vos = P.online.OnlineDriver(P.resources.paper_pool(), P.cost_model.CostModel(),
                                policy="vos")
    vos.submit(wl.instance(0), arrival_t=0.0)
    for _ in range(8):
        vos.step()
    vos.submit(wl.instance(1), arrival_t=500.0, curve=P.vos.ValueCurve.step(1e4, value=1.0))
    vos.submit(wl.instance(2), arrival_t=600.0, curve=P.vos.ValueCurve.step(1e4, value=100.0))
    shed = [dag.name for dag, _t in vos.shed_pending(1)]
    return rep.shed, list(drv.result().shed), _tuples(sched), shed


def _rejoin(P):
    wl = P.workloads.ds_workload()
    drv = P.online.OnlineDriver(P.resources.paper_pool(), P.cost_model.CostModel(),
                                policy="eft")
    for i in range(6):
        drv.submit(wl.instance(i), arrival_t=i * 3.0)
    for _ in range(30):
        drv.step()
    t = max(a.start for a in drv.eng.assignments)
    drv.fail(t, ["xeon0", "xeon1", "xeon2"])
    early = drv.rejoin(t + 1.0, P.resources.paper_pool().subset(["xeon0"]))
    t_ok = drv.pe_backoff.rejoin_at("xeon0") + 1.0
    late = drv.rejoin(t_ok, P.resources.paper_pool().subset(["xeon0"]))
    for i in range(6, 12):
        drv.submit(wl.instance(i), arrival_t=t_ok)
    return early, late, _tuples(drv.run())


def _apply_health(P):
    wl, pool = P.workloads.ds_workload(), P.resources.paper_pool()
    drv = P.online.OnlineDriver(pool, P.cost_model.CostModel(), policy="eft")
    for i in range(6):
        drv.submit(wl.instance(i), arrival_t=0.0)
    for _ in range(30):
        drv.step()
    mon = P.elastic.HealthMonitor([p.name for p in pool.pes], heartbeat_timeout=5.0)
    for _ in range(4):
        for p in pool.pes:
            if p.name != "xeon1":
                mon.observe(p.name, 10.0 if p.name == "volta0" else 1.0, now=8.0)
    rep = drv.apply_health(mon, now=10.0)
    return rep.dead_pes, rep.lost, [p.name for p in drv.pool.pes], _tuples(drv.run())


@pytest.mark.parametrize(
    "scenario", [_link_failure, _retry_exhaustion, _shed, _rejoin, _apply_health],
    ids=["link_failure", "retry_exhaustion", "shed_pending", "rejoin", "apply_health"],
)
def test_failure_events_match_reference(scenario):
    ref, port = _both(scenario)
    assert port == ref


def _lineage(P):
    R = P.recovery
    chain = {"a": R.TaskRecord("p1", 0.0, 0.0, 10.0), "b": R.TaskRecord("p2", 10.0, 12.0, 20.0),
             "c": R.TaskRecord("p2", 20.0, 20.0, 30.0), "d": R.TaskRecord("p3", 0.0, 0.0, 25.0)}
    succs = {"a": ["b"], "b": ["c"], "c": [], "d": []}
    preds = {"a": [], "b": ["a"], "c": ["b"], "d": []}
    out = [R.compute_lost(chain, succs.__getitem__, preds.__getitem__, set(dead), t,
                          extra_lost=frozenset(extra))
           for dead, t, extra in ((["p1"], 5.0, ()), (["p1"], 15.0, ()), (["p1"], 11.0, ()),
                                  (["p3"], 26.0, ()), ([], 11.0, ("b",)))]
    out.append(R.lost_exec_seconds(chain, ["a", "b"], 14.0))
    rs = R.RetryState(budget=3, backoff_base=2.0)
    out.append([rs.charge(["x"], t) for t in (100.0, 200.0, 300.0, 400.0)])
    bo = R.PEBackoff(base=30.0, max_window=100.0)
    out.append([bo.record_failure("pe", t) for t in (0.0, 50.0, 200.0)])
    return out


def test_lineage_and_backoff_match_reference():
    ref, port = _both(_lineage)
    assert port == ref


# ---------------------------------------------------------------------------
# Sites: federation, partitions, site loss (test_federation.py, test_partition.py)
# ---------------------------------------------------------------------------

def _flatten(P):
    flat = P.federation.paper_federation().flatten()
    links = sorted((k, l.bandwidth, l.latency) for k, l in flat._links.items())
    return [(p.name, p.kind, p.location, p.speed) for p in flat.pes], links, flat.site_of


def test_paper_federation_flattens_as_reference():
    ref, port = _both(_flatten)
    assert port == ref
    pool = PORT.resources.paper_pool()
    names, _, _ = _flatten(PORT)
    assert [n for n, *_ in names] == [p.name for p in pool.pes]


def _flatten_schedules(P, policy):
    merged = P.dag.merge([P.workloads.ds_workload().instance(i) for i in range(3)])
    cost = P.cost_model.CostModel()
    live = P.schedulers.schedule(merged, P.federation.paper_federation().flatten(), cost,
                                 policy=policy)
    seed = P.schedulers_reference.schedule_reference(merged, P.resources.paper_pool(), cost,
                                                     policy=policy)
    assert _tuples(live) == _tuples(seed)
    fed = P.online.OnlineDriver(P.federation.paper_federation(), cost, policy=policy)
    for i in range(3):
        fed.submit(P.workloads.ds_workload().instance(i), arrival_t=i * 3.0)
    return _tuples(live), _tuples(fed.run())


@pytest.mark.parametrize("policy", POLICIES)
def test_schedule_reference_and_federation_match_reference(policy):
    """The frozen seed engine equals ``schedule`` on the flattened
    federation in each package, and the two packages agree."""
    ref, port = _both(_flatten_schedules, policy)
    assert port == ref


def _fed_driver(P, policy, n=4, period=4.0):
    fed = P.federation.paper_federation()
    cost = P.cost_model.CostModel(data_home=fed.data_home)
    drv = P.online.OnlineDriver(fed, cost, policy=policy)
    wl = _template(P, 0, name="part")
    for i in range(n):
        drv.submit(wl.instance(i), arrival_t=i * period)
    return drv, fed, cost


def _partition(P, policy):
    out = []
    for heal in (False, True):
        drv, fed, cost = _fed_driver(P, policy)
        for _ in range(5):
            drv.step()
        t = max(a.start for a in drv.eng.assignments)
        rep = drv.partition(t, "dc")
        out.append((rep.deadline, rep.floored_pes, sorted(rep.floored_links)))
        for _ in range(0 if policy == "rr" else 3):
            drv.step()
        if heal:
            drv.heal(t + 10.0, "dc")
            for _ in range(0 if policy == "rr" else 3):
                drv.step()
        rec = _record(drv)
        a = _tuples(drv.run())
        assert a == _tuples(_restart(P, drv.pool, cost, policy, rec).run())
        out.append(a)
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_partition_restart_differential_matches_reference(policy):
    ref, port = _both(_partition, policy)
    assert port == ref


def _site_loss(P):
    drv, fed, cost = _fed_driver(P, "etf")
    for _ in range(7):
        drv.step()
    t = max(a.start for a in drv.eng.assignments)
    rep = drv.fail_site(t, "dc", shed=1)
    early = drv.rejoin_site(t + 1.0, "dc")
    for _ in range(3):
        drv.step()
    rec = _record(drv)
    a = _tuples(drv.run())
    assert a == _tuples(_restart(P, drv.pool, cost, "etf", rec).run())
    late_drv, _, late_cost = _fed_driver(P, "eft")
    for _ in range(8):
        late_drv.step()
    t = max(x.start for x in late_drv.eng.assignments)
    prep = late_drv.partition(t, "dc")
    for _ in range(4):
        late_drv.step()
    esc = late_drv.heal(prep.deadline + 100.0, "dc")
    return (rep.dead_pes, rep.shed, early, a, esc.lost, esc.t,
            _tuples(late_drv.run()))


def test_site_loss_and_late_heal_match_reference():
    ref, port = _both(_site_loss)
    assert port == ref


# ---------------------------------------------------------------------------
# Preemption (tests/test_online.py, value-aware preemption)
# ---------------------------------------------------------------------------

def _preempt(P, racing_partition):
    wl = P.workloads.ds_workload()
    if racing_partition:
        pool = P.federation.paper_federation(n_arm=2, n_xeon=2)
        cost = P.cost_model.CostModel(data_home=pool.data_home)
    else:
        pool, cost = P.resources.paper_pool(), P.cost_model.CostModel()
    drv = P.online.OnlineDriver(pool, cost, policy="vos")
    cold = P.vos.ValueCurve.linear_decay(2e4, 9e4, value=0.2)
    for i in range(2):
        drv.submit(wl.instance(i), arrival_t=0.0, curve=cold)
    for _ in range(10 if racing_partition else 12):
        assert drv.step() is not None
    a = drv.eng.assignments[-1]
    t = (a.start + a.finish) / 2.0
    if racing_partition:
        drv.partition(t, "dc", defer="all")
        t += 1.0
    hot = P.vos.ValueCurve.linear_decay(t + 5e4, t + 9e4, value=50.0)
    rep = drv.admit_preempting(wl.instance(7), t, curve=hot)
    rec = _record(drv)
    curves = drv.slo_curves()
    a_run = _tuples(drv.run())
    b_run = _tuples(_restart(P, pool, cost, "vos", rec, curves=curves).run())
    assert a_run == b_run
    res = drv.result()
    return (rep.victim, rep.victim_pe, rep.victim_value, rep.arrival_value, rep.displaced,
            rep.resume_floor, rep.checkpoint_seconds, res.n_preemptions, res.n_displaced,
            drv.horizon_events[-1][1:], a_run)


@pytest.mark.parametrize("racing_partition", [False, True])
def test_admit_preempting_matches_reference(racing_partition):
    ref, port = _both(_preempt, racing_partition)
    assert port == ref


# ---------------------------------------------------------------------------
# The chaos counterexample of the reference (tests/test_chaos.py)
# ---------------------------------------------------------------------------

def _chaos(P, seed, k, n_dead, dead_at, frac, period, policy):
    """test_chaos_recovery_invariants' scenario; returns what its checks
    read: the restart differential, the placed names and every
    dependency that executes before its producer's finish."""
    wl = _template(P, seed, name="chaos")
    pool = P.resources.paper_pool(n_arm=2, n_xeon=2)
    cost = P.cost_model.CostModel()
    drv = P.online.OnlineDriver(pool, cost, policy=policy)
    for i in range(5):
        drv.submit(wl.instance(i), arrival_t=i * period)
    for _ in range(k):
        if drv.step() is None and not drv.pending:
            break
    starts = sorted(a.start for a in drv.eng.assignments)
    t_fail = starts[int(frac * (len(starts) - 1))]
    rng = np.random.default_rng(dead_at)
    dead = list(rng.choice([p.name for p in pool.pes], size=n_dead, replace=False))
    rep = drv.fail(t_fail, dead)
    rec = _record(drv)
    sched_a = drv.run()
    same = _tuples(sched_a) == _tuples(_restart(P, drv.pool, cost, policy, rec).run())
    by_task = {a.task: a for a in sched_a.assignments}
    early = []
    for inst in drv.instances:
        if inst.name in set(rec["cancelled"]):
            continue
        for t_ in inst.dag.tasks:
            a = by_task[t_.name]
            for p in inst.dag.predecessors(t_.name):
                if a.start + a.comm_wait < by_task[p.name].finish - 1e-9:
                    early.append((t_.name, p.name, a.start, by_task[p.name].finish))
    return same, rep.lost, sorted(by_task), early


def test_chaos_counterexample_behaves_as_in_reference():
    """The example the reference's chaos test finds now and then
    (``seed=0, k=18, n_dead=2, dead_at=4, frac=1.0, period=0.0,
    policy='rr'``): the copy inherits the reference's recovery, so it
    reports the same dependency check, violation included."""
    args = (0, 18, 2, 4, 1.0, 0.0, "rr")
    ref, port = _both(_chaos, *args)
    assert port == ref


@pytest.mark.parametrize("seed,k,policy", [(3, 12, "eft"), (11, 25, "heft"), (7, 6, "vos")])
def test_chaos_examples_match_reference(seed, k, policy):
    ref, port = _both(_chaos, seed, k, 1, seed, 0.5, 2.0, policy)
    assert port == ref


# ---------------------------------------------------------------------------
# HealthMonitor and prune_pool (tests/test_vdc_elastic.py)
# ---------------------------------------------------------------------------

def _monitor(P):
    el = P.elastic
    mon = el.HealthMonitor(["a", "b", "c", "d"], patience=2, heartbeat_timeout=10.0)
    seen = []
    for step in range(4):
        for w in "abcd":
            mon.observe(w, 2.5 if w == "d" else 1.0, now=float(step))
        seen.append(mon.stragglers())
    mon.mark_dead("d")
    seen += [mon.healthy(), mon.dead(now=100.0)]
    polls = el.HealthMonitor(["a", "b", "c"], patience=3)
    for w in "abc":
        polls.observe(w, 3.0 if w == "c" else 1.0, now=0.0)
    seen.append([polls.stragglers() for _ in range(3)])
    for now in (1.0, 2.0):
        polls.observe("c", 3.0, now=now)
        seen.append(polls.stragglers())
    late = el.HealthMonitor(["w0", "w1"], heartbeat_timeout=10.0, now=1000.0)
    seen += [late.dead(now=1005.0), late.dead(now=1011.0)]
    sweep = el.HealthMonitor(["w0", "w1"], heartbeat_timeout=10.0)
    sweep.heartbeat("w0", now=95.0)
    seen += [sweep.sweep_dead(now=100.0), sweep.healthy(), sweep.sweep_dead(now=100.0)]
    pool = P.resources.paper_pool()
    slow = el.HealthMonitor([p.name for p in pool.pes])
    for p in pool.pes:
        for _ in range(4):
            slow.observe(p.name, step_s=10.0 if p.name == "xeon1" else 1.0, now=1.0)
    pruned = el.prune_pool(pool, slow, also_drop=slow.stragglers())
    seen.append([p.name for p in pruned.pes])
    fed = P.federation.paper_federation().flatten()
    site = el.HealthMonitor([p.name for p in fed.pes])
    for p in fed.pes:
        if p.location == "backend":
            site.mark_dead(p.name)
    site_pruned = el.prune_pool(fed, site)
    seen.append(([p.name for p in site_pruned.pes], sorted(site_pruned._links)))
    seen.append([el.plan_remesh(d, 2, 4) for d in (2, 5, 8, 16)])
    seen.append([el.rebalance_batch(gb, ax) for gb, ax in ((64, 3), (1, 8), (100, 10))])
    return seen


def test_health_monitor_and_prune_pool_match_reference():
    ref, port = _both(_monitor)
    assert port == ref
