# fmt: off
# A copy of src/repro/core/cost_model.py, kept in its hand-aligned layout so the
# two stay diffable line for line; the imports name repro_torch, the TPU
# rates are left out and the roofline defaults are H100 constants.
"""Execution-time / energy / communication cost model (paper §4).

The paper assumes "historical execution time data for each task node on each
of the compute resources" and charges communication for backend placement at
a measured channel rate (12 Mbps). Those historical tables are not published,
so — exactly like the paper — we *calibrate* per-(operator-family, PE-kind)
throughputs from public device characteristics, and additionally provide a
:class:`LearnedCostModel` that fits the tables from observed executions (the
paper's "statistical and data-mining techniques [20–23]" for performance
prediction).

Time model
    exec_time(task, pe)   = task.work / (rate[family(op)][pe.kind] * pe.speed)
    comm_time(bytes, l)   = latency + bytes / bandwidth        (cross-location)
    arrival charge        = in_bytes upload for SOURCE tasks placed off the
                            data's home location (the paper's RQ1 effect).

Energy model (for VoS)
    energy(task, pe) = exec_time * power_busy      (+ idle integrated later)

Roofline mode
    :func:`roofline_time` combines the three classic terms (compute / HBM /
    interconnect) from analytic FLOPs+bytes, priced at H100 SXM constants
    (used by :meth:`repro_torch.core.vdc.VDCManager.size_for_slo`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dag import Task
from repro_torch.core.resources import ProcessingElement, ResourcePool

# ---------------------------------------------------------------------------
# Operator families — which device family accelerates which operator
# ---------------------------------------------------------------------------

#: op -> family. "etl" ops are branch/string heavy (CPUs fine, accelerators
#: marginal); "ml" ops are dense-linear-algebra (GPU/FPGA shine);
#: "stream" ops are windowed reductions (memory-bound, accelerators ~ok).
OP_FAMILY: Dict[str, str] = {
    "ingest": "etl",
    "sql_transform": "etl",
    "select_columns": "etl",
    "clean_missing": "etl",
    "join": "etl",
    "summarize": "stream",
    "window_agg": "stream",
    "anomaly": "stream",
    "filter_features": "ml",
    "kmeans": "ml",
    "sweep_clustering": "ml",
    "train_cluster": "ml",
    "linreg": "ml",
    "score": "ml",
    "pca": "ml",
    "export": "etl",
    "lm_train_step": "ml",
    "lm_prefill": "ml",
    "lm_decode": "ml",
}


def family(op: str) -> str:
    return OP_FAMILY.get(op, "etl")


# ---------------------------------------------------------------------------
# Calibrated throughput tables (work-units / second)
# ---------------------------------------------------------------------------
# Relative rates follow public device characteristics:
#   ARM A72-class core   ~  1x scalar baseline (4x w/ NEON on dense ML)
#   Xeon server core     ~  4x scalar (wider SIMD, higher clock)
#   Volta (Jetson-class) ~  8x on dense ML, ~1.5x on ETL (launch overheads)
#   V100 (DC GPU)        ~ 40x on dense ML, ~2x  on ETL
#   Alveo FPGA           ~ 25x on streaming/ML pipelines, ~1x ETL
#   host_cpu (pod host)  ~  Xeon-class
# CALIBRATION: the paper publishes only aggregate results, not its tables;
# the ARM ml/stream entries were co-calibrated with the workload's work
# units (see repro.pipeline.workloads._NODES) to reproduce the paper's
# reported aggregates. Sweep script: benchmarks/calibration.py.
RATE: Dict[str, Dict[str, float]] = {
    "etl": {
        "arm": 1.0, "volta": 1.5, "xeon": 4.0, "v100": 2.0, "alveo": 1.0,
        "host_cpu": 4.0,
    },
    "stream": {
        "arm": 2.0, "volta": 4.0, "xeon": 4.0, "v100": 12.0, "alveo": 25.0,
        "host_cpu": 4.0,
    },
    "ml": {
        "arm": 4.0, "volta": 8.0, "xeon": 4.0, "v100": 40.0, "alveo": 25.0,
        "host_cpu": 4.0,
    },
}


class CostModel:
    """Calibrated-table cost model (the paper's "historical data")."""

    def __init__(self, rate: Optional[Mapping[str, Mapping[str, float]]] = None,
                 data_home: str = "frontend") -> None:
        self.rate = {f: dict(r) for f, r in (rate or RATE).items()}  # det: ok key-addressed rebuild; caller-order insertion
        #: where raw sensor data lives; source tasks placed elsewhere pay the
        #: upload (paper: data flow starts at the edge).
        self.data_home = data_home

    # -- time -----------------------------------------------------------------
    def exec_time(self, task: Task, pe: ProcessingElement) -> float:
        fam = family(task.op)
        base = self.rate.get(fam, {}).get(pe.kind)
        if base is None or base <= 0:
            raise KeyError(f"no rate for family {fam!r} on kind {pe.kind!r}")
        return task.work / (base * pe.speed)

    def input_arrival_time(self, task: Task, pe: ProcessingElement,
                           pool: ResourcePool) -> float:
        """Upload cost of raw input for source tasks (paper RQ1).

        The paper: "the Server-only configuration relies on the frontend to
        send larger amounts of input data at the very beginning of workload
        execution, which increases the execution time significantly".
        """
        if task.in_bytes <= 0 or pe.location == self.data_home:
            return 0.0
        return pool.transfer_time(self.data_home, pe.location, task.in_bytes)

    def comm_time(self, nbytes: float, src_pe: ProcessingElement,
                  dst_pe: ProcessingElement, pool: ResourcePool) -> float:
        if src_pe.name == dst_pe.name:
            return 0.0
        return pool.transfer_time(src_pe.location, dst_pe.location, nbytes)

    # -- vectorized tables (scheduler fast path) ------------------------------
    def rate_matrix(self, pes: Sequence[ProcessingElement]
                    ) -> Tuple[Tuple[str, ...], "np.ndarray"]:
        """``(families, R)`` where ``R[f, j] = rate[family_f][pes[j].kind] *
        pes[j].speed`` (work-units/second) and missing/non-positive entries
        are NaN. Families are sorted for a stable row order."""
        families = tuple(sorted(self.rate))
        rows: List[List[float]] = []
        for fam in families:
            table = self.rate[fam]
            row = []
            for p in pes:
                base = table.get(p.kind)
                # NaN routes the engine to the scalar method, which raises
                # (or misbehaves) exactly as the pre-batch code did — keeps
                # scalar/batch behaviour identical for degenerate speeds too
                row.append(base * p.speed
                           if base is not None and base > 0 and p.speed > 0
                           else float("nan"))
            rows.append(row)
        return families, np.asarray(rows, dtype=np.float64)

    def exec_time_batch(self, tasks: Sequence[Task],
                        pes: Sequence[ProcessingElement]) -> "np.ndarray":
        """Dense ``(len(tasks), len(pes))`` exec-time table.

        Bitwise-identical to calling :meth:`exec_time` per pair (same IEEE
        ``work / (base * speed)`` on the same float64 operands); pairs with
        no calibrated rate are NaN — callers must raise on use, matching the
        scalar method's KeyError. Used by the incremental scheduling engine
        so its inner loop is an array lookup, not dict-of-dict probes.
        """
        families, R = self.rate_matrix(pes)
        fam_row = {f: i for i, f in enumerate(families)}
        nan_row = len(families)
        R = np.vstack([R, np.full((1, len(pes)), np.nan)])
        fam_ids = np.asarray([fam_row.get(family(t.op), nan_row)
                              for t in tasks], dtype=np.intp)
        work = np.asarray([t.work for t in tasks], dtype=np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            return work[:, None] / R[fam_ids, :]

    def energy_batch(self, tasks: Sequence[Task],
                     pes: Sequence[ProcessingElement]) -> "np.ndarray":
        """Dense busy-energy table: ``exec_time_batch * power_busy``."""
        power = np.asarray([p.power_busy for p in pes], dtype=np.float64)
        return self.exec_time_batch(tasks, pes) * power[None, :]

    # -- energy ---------------------------------------------------------------
    def energy(self, task: Task, pe: ProcessingElement) -> float:
        return self.exec_time(task, pe) * pe.power_busy

    # -- scheduler helpers ----------------------------------------------------
    def mean_exec_time(self, task: Task, pool: ResourcePool) -> float:
        ts = [self.exec_time(task, p) for p in pool.pes]
        return sum(ts) / len(ts)

    def mean_comm_time(self, task: Task, pool: ResourcePool) -> float:
        """Average cross-location cost of shipping ``task.out_bytes``."""
        locs = pool.locations
        if len(locs) < 2 or task.out_bytes <= 0:
            return 0.0
        acc, n = 0.0, 0
        for a in locs:
            for b in locs:
                if a != b and pool.link(a, b) is not None:
                    acc += pool.transfer_time(a, b, task.out_bytes)
                    n += 1
        return acc / max(n, 1)


def row_ids(table: "np.ndarray",
            seen: Optional[Dict[bytes, int]] = None) -> List[int]:
    """Dense row-identity ids for a per-(task, PE) cost table.

    ``row_ids(E)[i] == row_ids(E)[k]`` iff tasks ``i`` and ``k`` have
    bit-identical cost rows (NaN included — missing rates compare equal to
    missing rates, never to real values). Two tasks with equal exec/energy
    rows are indistinguishable to every scheduling-policy key except for
    their name tie-break, which is what lets the incremental engine fold
    them into one candidate class. O(V·P) hashing, done once per engine.

    ``seen`` is an optional persistent registry (row bytes → id): the online
    engine passes one so tasks admitted in *different* batches still share
    ids when their cost rows are bit-identical (instances of one template
    workload collapse into shared candidate classes across admissions)."""
    mat = np.ascontiguousarray(table, dtype=np.float64)
    width = mat.shape[1] * mat.itemsize
    if width == 0:  # no PEs: every (empty) row is identical
        return [0] * mat.shape[0]
    if seen is None:
        seen = {}
    raw = mat.tobytes()
    return [seen.setdefault(raw[off:off + width], len(seen))
            for off in range(0, len(raw), width)]


# ---------------------------------------------------------------------------
# Learned cost model (paper refs [20-23]: regression-based prediction)
# ---------------------------------------------------------------------------

class LearnedCostModel(CostModel):
    """Fits per-(op, kind) throughput from observed (work, seconds) samples.

    Ridge-regularised one-parameter fit: rate = Σ(work·t)/Σ(t²+λ). Falls back
    to the calibrated table until ≥ ``min_samples`` observations exist.
    """

    def __init__(self, base: Optional[CostModel] = None, min_samples: int = 3,
                 ridge: float = 1e-9) -> None:
        base = base or CostModel()
        super().__init__(base.rate, base.data_home)
        self.min_samples = min_samples
        self.ridge = ridge
        self._obs: Dict[Tuple[str, str], list] = {}

    def observe(self, task: Task, pe: ProcessingElement, seconds: float) -> None:
        if seconds <= 0:
            return
        key = (family(task.op), pe.kind)
        self._obs.setdefault(key, []).append((task.work, seconds * pe.speed))

    def exec_time(self, task: Task, pe: ProcessingElement) -> float:
        key = (family(task.op), pe.kind)
        samples = self._obs.get(key, ())
        if len(samples) >= self.min_samples:
            num = sum(w * t for w, t in samples)
            den = sum(t * t for _, t in samples) + self.ridge
            rate = num / den  # work per (speed-normalised) second
            if rate > 0:
                return task.work / (rate * pe.speed)
        return super().exec_time(task, pe)


def rate_table_with(model: LearnedCostModel, kind: str,
                    measured_on: Sequence[str]) -> Dict[str, Dict[str, float]]:
    """``model``'s rate table with a column for ``kind``, fitted from samples.

    For each family, the rate is :class:`LearnedCostModel`'s ridge fit over
    the samples the executor observed on the PE kinds ``measured_on``: PEs
    whose tasks ran on the card that ``kind`` names (the port runs every
    non-host PE of ``paper_pool`` on one card). A family with fewer than
    ``model.min_samples`` samples gets no entry, so scheduling it on
    ``kind`` raises, as a missing rate does. Pass the table to
    ``CostModel(rate=...)`` to schedule over :func:`~repro_torch.core.resources.gpu_pool`.
    """
    table = {f: dict(r) for f, r in sorted(model.rate.items())}
    for fam in sorted({f for f, _ in model._obs}):
        samples = [s for k in measured_on for s in model._obs.get((fam, k), ())]
        if len(samples) < model.min_samples:
            continue
        num = sum(w * t for w, t in samples)
        den = sum(t * t for _, t in samples) + model.ridge
        if num / den > 0:
            table.setdefault(fam, {})[kind] = num / den
    return table


# ---------------------------------------------------------------------------
# Roofline pricing for jobs on VDC slices
# ---------------------------------------------------------------------------

#: NVIDIA H100 SXM constants per card (NVIDIA H100 data sheet, dense rates,
#: 700 W power limit); keep in one place.
H100_PEAK_FLOPS = 989e12     # bf16 FLOP/s, tensor cores, dense
H100_HBM_BW = 3.35e12        # bytes/s, HBM3
H100_NVLINK_BW = 450e9       # bytes/s each way per card (NVLink 4, 900 GB/s total)
H100_NET_BW = 50e9           # bytes/s between hosts (DGX H100: 400 Gb/s NIC per card)
H100_PCIE_BW = 64e9          # bytes/s each way, host to card (PCIe Gen5 x16)


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def step_time(self) -> float:
        # lower bound assuming perfect overlap: limited by the max term
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def serial_time(self) -> float:
        # upper bound assuming zero overlap
        return self.compute_s + self.memory_s + self.collective_s


def roofline_time(flops: float, hbm_bytes: float, ici_bytes: float,
                  chips: int, dcn_bytes: float = 0.0,
                  peak_flops: float = H100_PEAK_FLOPS,
                  hbm_bw: float = H100_HBM_BW,
                  ici_bw: float = H100_NVLINK_BW,
                  dcn_bw: float = H100_NET_BW) -> RooflineTerms:
    """Three-term roofline for a step on a slice of ``chips`` chips.

    ``flops``/``hbm_bytes`` are *global* (whole-step) quantities; the
    collective byte counts are *per-chip on-wire* bytes (already scaled by
    ring factors by the caller).
    """
    chips = max(chips, 1)
    compute = flops / (chips * peak_flops)
    memory = hbm_bytes / (chips * hbm_bw)
    coll = ici_bytes / ici_bw + (dcn_bytes / dcn_bw if dcn_bytes else 0.0)
    return RooflineTerms(compute, memory, coll)
