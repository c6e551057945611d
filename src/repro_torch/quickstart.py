"""Quickstart of the port: the paper's data-science loop on the card.

1. Build the paper's 16-task DS workload (Fig. 5) with real backends.
2. Compose a VDC from the device pool (just-in-time).
3. Schedule it with the paper's EFT policy over the hierarchical edge/DC
   pool, then execute it: host tasks on the edge (numpy), device tasks on
   the VDC's first device (torch and the port's CUDA kernels).

Each instance gets its own raw batch of ``rows`` × 8 float32 sensor
columns made from its seed (500,000 rows are the workload's declared
16 MB ``ingest`` volume) and runs through the one EFT schedule.

    PYTHONPATH=src python -m repro_torch.quickstart            # on the card
    PYTHONPATH=src python -m repro_torch.quickstart --cpu --rows 512
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.convert import resolve_device
from repro_torch.core.cost_model import CostModel
from repro_torch.core.executor import ExecutionReport, Executor
from repro_torch.core.resources import paper_pool
from repro_torch.core.schedulers import Schedule, schedule
from repro_torch.core.vdc import SLO, VDCManager
from repro_torch.pipeline.workloads import ds_workload_executable

N_COLS = 8


def raw_batch(seed: int, rows: int) -> np.ndarray:
    """One instance's raw sensor batch: ``rows`` × 8 standard normals."""
    return np.random.default_rng(seed).normal(0, 1, (rows, N_COLS)).astype(np.float32)


def run(
    device: Optional[object] = None,
    rows: int = 500_000,
    instances: int = 3,
    backend_of: Optional[Callable[[str], str]] = None,
) -> Tuple[Schedule, List[ExecutionReport]]:
    """Steps 1–3: the EFT schedule and one execution report per instance
    (seeds 0 .. instances - 1). ``backend_of`` overrides the PE → backend
    map, e.g. ``lambda pe: "host"`` for the host-only run."""
    dev = resolve_device(device)
    wl = ds_workload_executable()  # declares the 16 MB ingest of 500,000 rows
    mgr = VDCManager(devices=[dev])
    vdc = mgr.compose(
        "quickstart", {"data": 1, "model": 1}, slo=SLO(step_deadline_s=60.0)
    )
    try:
        pool = paper_pool()
        sched = schedule(wl, pool, CostModel(), policy="eft")
        ex = Executor(pool, backend_of=backend_of, device=vdc.devices[0])
        reports = [
            ex.execute(wl, sched, inputs={"ingest": raw_batch(seed, rows)})
            for seed in range(instances)
        ]
    finally:
        mgr.release("quickstart")
    return sched, reports


def main(
    device: Optional[object] = None, rows: int = 500_000, instances: int = 3
) -> None:
    sched, reports = run(device, rows, instances)
    print(
        f"EFT predicted makespan: {sched.makespan:.1f}s "
        f"(mean util {sched.mean_utilization:.2f}, split {sched.location_split()})"
    )
    for seed, rep in enumerate(reports):
        digest = np.asarray(rep.outputs["export"].tolist())
        print(
            f"instance {seed}: {rep.wall_seconds * 1e3:.0f} ms wall, "
            f"backends {rep.by_backend}, export digest {digest}"
        )
    print("quickstart OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run device tasks on the CPU")
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--instances", type=int, default=3)
    args = ap.parse_args()
    main("cpu" if args.cpu else None, args.rows, args.instances)
