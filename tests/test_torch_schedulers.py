"""The port's scheduler core vs a live run of the reference: identical
(task, pe, start, finish) assignment lists for all 7 policies."""

import pytest

from repro.core import cost_model as ref_cost_model
from repro.core import dag as ref_dag
from repro.core import resources as ref_resources
from repro.core import schedulers as ref_schedulers
from repro.pipeline import workloads as ref_workloads
from repro_torch.core import cost_model, dag, resources, schedulers
from repro_torch.pipeline import workloads


def _rows(sched):
    return [(a.task, a.pe, a.start, a.finish) for a in sched.assignments]


def test_same_policies():
    assert schedulers.POLICIES == ref_schedulers.POLICIES


@pytest.mark.parametrize("policy", ref_schedulers.POLICIES)
@pytest.mark.parametrize("instances", [1, 3])
def test_schedule_byte_identical_to_reference(policy, instances):
    def build(dag_mod, wl_mod):
        base = wl_mod.ds_workload()
        if instances == 1:
            return base
        return dag_mod.merge([base.instance(i) for i in range(instances)])

    mine = schedulers.schedule(
        build(dag, workloads),
        resources.paper_pool(),
        cost_model.CostModel(),
        policy=policy,
    )
    ref = ref_schedulers.schedule(
        build(ref_dag, ref_workloads),
        ref_resources.paper_pool(),
        ref_cost_model.CostModel(),
        policy=policy,
    )
    assert repr(_rows(mine)) == repr(_rows(ref))
    assert mine.makespan == ref.makespan


def test_roofline_defaults_are_h100():
    terms = cost_model.roofline_time(989e12, 3.35e12, 450e9, chips=1)
    assert (terms.compute_s, terms.memory_s, terms.collective_s) == (1.0, 1.0, 1.0)
