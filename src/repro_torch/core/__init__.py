"""Scheduler core, executor and VDC manager of the port.

The names of ``repro.core``, with :func:`gpu_pool` in the place of the
reference's ``tpu_pool``. Each is imported from its submodule on first
use, so importing one submodule pulls in nothing beyond what it needs.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "dag": ("PipelineDAG", "Task", "merge"),
    "resources": ("BACKEND", "FRONTEND", "Link", "ProcessingElement", "ResourcePool",
                  "paper_pool", "gpu_pool"),
    "cost_model": ("CostModel", "LearnedCostModel", "RooflineTerms", "roofline_time"),
    "schedulers": ("POLICIES", "SCHEDULERS", "Assignment", "OnlineEngine", "Schedule",
                   "schedule"),
    "online": ("OnlineDriver", "OnlineRunResult", "restart_from_history", "run_online"),
    "recovery": ("PEBackoff", "RecoveryReport", "RetryState", "TaskRecord", "compute_lost"),
    "vos": ("ValueCurve", "VoSSpec", "instance_curves", "slo_mix", "system_vos",
            "uniform_specs"),
}
_HOME = {name: mod for mod, names in _EXPORTS.items() for name in names}  # det: ok key-addressed

__all__ = [n for names in _EXPORTS.values() for n in names] + ["simulator"]  # det: ok literal order


def __getattr__(name: str):
    if name == "simulator":
        return importlib.import_module(f"{__name__}.simulator")
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
    globals()[name] = value
    return value
