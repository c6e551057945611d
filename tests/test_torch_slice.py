"""Slice 1 end to end on the CPU: the port's quickstart path (EFT schedule →
executor → host and device operators) vs the reference executor on the same
schedule and the same raw batch; executor failure semantics and VDC
composition vs the reference."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.core.cost_model import CostModel as RefCostModel
from repro.core.executor import Executor as RefExecutor
from repro.core.resources import paper_pool as ref_paper_pool
from repro.core.schedulers import schedule as ref_schedule
from repro.core.vdc import AllocationError as RefAllocationError
from repro.core.vdc import SLO as RefSLO
from repro.core.vdc import VDCManager as RefVDCManager
from repro.pipeline.workloads import ds_workload_executable as ref_workload
from repro_torch import convert, quickstart
from repro_torch.core.cost_model import CostModel
from repro_torch.core.executor import Executor
from repro_torch.core.resources import paper_pool
from repro_torch.core.schedulers import schedule
from repro_torch.core.vdc import SLO, AllocationError, VDCManager
from repro_torch.pipeline.workloads import ds_workload_executable

TOL = dict(rtol=3e-4, atol=3e-4)


def _leaves(tree):
    return [np.asarray(x) for x in convert.leaves(convert.to_numpy(tree))]


def _assert_outputs_close(mine, ref):
    assert sorted(mine) == sorted(ref)
    for name in sorted(ref):
        a, b = _leaves(mine[name]), _leaves(ref[name])
        assert len(a) == len(b), name
        for u, v in zip(a, b, strict=True):
            assert u.shape == v.shape, name
            np.testing.assert_allclose(u, v, err_msg=name, **TOL)


@pytest.mark.parametrize("rows", [512, 1000])
def test_quickstart_path_matches_reference_executor(rows):
    sched, (rep,) = quickstart.run(device="cpu", rows=rows, instances=1)
    ref_sched = ref_schedule(
        ref_workload(), ref_paper_pool(), RefCostModel(), policy="eft"
    )
    ref = RefExecutor(ref_paper_pool()).execute(
        ref_workload(), ref_sched, inputs={"ingest": quickstart.raw_batch(0, rows)}
    )
    assert [(r.task, r.pe, r.backend) for r in rep.runs] == [
        (r.task, r.pe, r.backend) for r in ref.runs
    ]
    assert rep.by_backend == ref.by_backend == {"host": 8, "device": 8}
    _assert_outputs_close(rep.outputs, ref.outputs)
    np.testing.assert_allclose(
        np.asarray(convert.to_numpy(rep.outputs["export"])),
        np.asarray(ref.outputs["export"]),
        **TOL,
    )
    # join: 4 anomaly flag columns, 4 tiled summary columns, the prediction
    assert float(np.asarray(convert.to_numpy(rep.outputs["export"]))[0]) == rows * 9


def test_device_tasks_get_tensors_and_host_tasks_numpy():
    seen = {}

    def record(side):
        def fn(*args):
            seen[side] = [type(a) for a in convert.leaves(list(args))]
            return args[0]

        return fn

    wl = ds_workload_executable()
    sched = schedule(wl, paper_pool(), CostModel(), policy="eft")
    for t in wl.tasks:
        t.backends = {"host": record("host"), "device": record("device")}
    Executor(paper_pool(), device="cpu").execute(
        wl, sched, inputs={"ingest": np.zeros((4, 8), np.float32)}
    )
    assert set(seen["host"]) == {np.ndarray}
    assert set(seen["device"]) == {torch.Tensor}


def test_executor_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Executor(paper_pool())
    with pytest.raises(RuntimeError, match="CUDA"):
        VDCManager()
    with pytest.raises(RuntimeError):
        quickstart.run(rows=8, instances=1)


# -- failure semantics -------------------------------------------------------


@dataclasses.dataclass
class _Event:
    kind: str
    worker: str
    factor: float = 1.0


class _Injector:
    """Events by execution step; reading does not consume them, so one
    injector drives both executors."""

    def __init__(self, events):
        self.events = events

    def at(self, step):
        return [ev for s, ev in self.events if s == step]


def _summary(rep):
    return (
        [(r.task, r.pe, r.backend) for r in rep.runs],
        rep.lost,
        rep.skipped,
        rep.dead,
        {k: sorted(v) for k, v in sorted(rep.copies.items())},
        sorted(rep.outputs),
    )


@pytest.mark.parametrize(
    "events,resume_events",
    [
        ([(6, _Event("die", "v100_0"))], [(0, _Event("rejoin", "v100_0"))]),
        ([(3, _Event("die", "volta0")), (9, _Event("rejoin", "volta0"))], []),
        (
            [(3, _Event("partition", "xeon0")), (12, _Event("heal", "xeon0"))],
            [],
        ),
        (
            [(2, _Event("slow", "arm0", 3.0)), (5, _Event("partition", "alveo0"))],
            [],
        ),
    ],
)
def test_failure_and_resume_semantics_match_reference(events, resume_events):
    def host(pe):  # the host backends keep this test fast
        return "host"

    raw = quickstart.raw_batch(1, 64)
    wl, ref_wl = ds_workload_executable(), ref_workload()
    sched = schedule(wl, paper_pool(), CostModel(), policy="eft")
    ref_sched = ref_schedule(ref_wl, ref_paper_pool(), RefCostModel(), policy="eft")
    ex = Executor(paper_pool(), backend_of=host, device="cpu")
    ref_ex = RefExecutor(ref_paper_pool(), backend_of=host)
    inj = _Injector(events)
    rep = ex.execute(wl, sched, {"ingest": raw}, injector=inj)
    ref = ref_ex.execute(ref_wl, ref_sched, {"ingest": raw}, injector=inj)
    assert _summary(rep) == _summary(ref)
    _assert_outputs_close(rep.outputs, ref.outputs)
    inj2 = _Injector(resume_events)
    rep2 = ex.execute(wl, sched, {"ingest": raw}, injector=inj2, resume_from=rep)
    ref2 = ref_ex.execute(
        ref_wl, ref_sched, {"ingest": raw}, injector=inj2, resume_from=ref
    )
    assert _summary(rep2) == _summary(ref2)
    assert rep2.complete(wl) == ref2.complete(ref_wl)
    _assert_outputs_close(rep2.outputs, ref2.outputs)


# -- VDC ---------------------------------------------------------------------


def _script(mgr, slo_cls, err_cls):
    """One compose/reserve/rollback/resize sequence; returns what it saw."""
    seen = []

    def attempt(fn, *a, **kw):
        try:
            v = fn(*a, **kw)
            seen.append(("ok", v.n_chips, v.axis_sizes, mgr.free_chips))
        except err_cls:
            seen.append(("refused", mgr.free_chips))

    slo = slo_cls(min_availability=0.2)
    attempt(mgr.compose, "too_big", {"data": 9}, slo=slo)
    attempt(mgr.compose, "a", {"data": 2, "model": 2}, slo=slo)
    attempt(mgr.compose, "a", {"data": 1})  # duplicate
    attempt(mgr.compose, "b", {"data": 4}, slo=slo)
    attempt(mgr.compose, "c", {"data": 1}, slo=slo)  # would break the reserve
    attempt(mgr.resize, "a", {"data": 6, "model": 1})  # too big: rolled back
    seen.append(("a", mgr.vdc("a").n_chips, mgr.vdc("a").axis_sizes))
    attempt(mgr.resize, "a", {"data": 5, "model": 1})
    mgr.release("b")
    seen.append(("released", mgr.free_chips))
    return seen


def test_vdc_compose_reserve_rollback_resize_match_reference():
    mine = _script(
        VDCManager(devices=[torch.device("cpu")] * 10), SLO, AllocationError
    )
    ref = _script(
        RefVDCManager(devices=list(jax.devices()) * 10), RefSLO, RefAllocationError
    )
    assert mine == ref


def test_vdc_federated_compose_matches_reference():
    def run(mgr_cls, dev, err_cls):
        mgr = mgr_cls(sites={"edge": [dev] * 2, "dc": [dev] * 4})
        shapes = {"edge": {"data": 1}, "dc": {"data": 2, "model": 1}}
        fed = mgr.compose_federated("f", shapes)
        out = [fed.n_chips, fed.sites, mgr.free_chips]
        try:
            mgr.compose_federated("g", {"dc": {"data": 1}, "edge": {"data": 2}})
        except err_cls:
            out.append(("refused", mgr.free_chips))
        mgr.release_federated("f")
        return out + [mgr.free_chips]

    assert run(VDCManager, torch.device("cpu"), AllocationError) == run(
        RefVDCManager, jax.devices()[0], RefAllocationError
    )


def test_vdc_mesh_and_slo_sizing_on_h100_constants():
    mgr = VDCManager(devices=[torch.device("cpu")] * 64)
    v = mgr.compose("m", {"data": 2, "model": 4})
    assert v.mesh.devices.shape == (2, 4) and v.mesh.axis_names == ("data", "model")
    assert all(d == torch.device("cpu") for d in v.mesh.devices.flat)
    # 1e15 bf16 FLOP at 989 TFLOP/s per card: 2 cards take 0.5056 s, 4 fit
    chips, terms = mgr.size_for_slo(SLO(step_deadline_s=0.5), 1e15, 1e11)
    assert chips == 4 and terms.step_time <= 0.5
    # 700 W per card: a 1 kW budget holds one card
    budget = SLO(step_deadline_s=1e-9, energy_budget_w=1000)
    chips2, _ = mgr.size_for_slo(budget, 1e15, 1e11)
    assert chips2 == 1
