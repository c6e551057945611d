"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card: its name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``;
3. hold each kernel against its plain torch version at the main path's
   shapes;
4. the main path: compose a VDC on ``cuda:0``, schedule the paper's 16-task
   DS workload with EFT over ``paper_pool()``, and execute 3 instances of
   500,000 × 8 float32 rows (seeds 0, 1, 2) through the port's quickstart
   entry point. The kernels' launch counts are read for this run alone, and
   every task's output is compared with the same pipeline run on the host
   backend only (placement must not change results);
5. time each kernel over one instance's calls on the path, beside its plain
   version and the least time the card could take (its bound).

Prints the card line and one JSON line of kernel results before the last
line, which is ``{"ok": true, "device": {...}}``. Exits non-zero, printing
no result, when there is no CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

ROWS = 500_000
INSTANCES = 3
#: H100 SXM data sheet: HBM3 bytes/s, float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
#: the kernels' calls in one pipeline instance under the EFT schedule:
#: sweep_clustering (k = 2, 3, 4, 6 on the 2 PCA columns, 10 steps each),
#: train_cluster (k = 4 on the 3 filtered columns, 20 steps); window_agg
#: (w = 8) and anomaly's two rolling means (w = 16) on 4 columns
KMEANS_CALLS = [(ROWS, 2, k, 10) for k in (2, 3, 4, 6)] + [(ROWS, 3, 4, 20)]
WINDOW_CALLS = [(ROWS, 4, 8, "mean", 1), (ROWS, 4, 16, "mean", 2)]
PER_INSTANCE = {"kmeans_assign": 60, "window_agg": 3}


def phase(name):
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def randn(shape, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(device)


# -- phase 3 -----------------------------------------------------------------


def check_kmeans(dev):
    from repro_torch.kernels.kmeans import kmeans_assign, kmeans_assign_ref
    from repro_torch.kernels.kmeans.ref import kmeans_distances

    cases = [(ROWS, 2, k) for k in (2, 3, 4, 6)] + [(ROWS, 3, 4)]
    extra = [(4097, 64, 300), (1000, 13_000, 3)]  # centroid chunks; uncached
    worst = 0.0
    for n, d, k in cases + extra:
        x, c = randn((n, d), n + d, dev), randn((k, d), k, dev)
        a, d2 = kmeans_assign(x, c)
        torch.cuda.synchronize()
        ar, d2r = kmeans_assign_ref(x, c)
        two = kmeans_distances(x, c).topk(2, dim=1, largest=False).values
        near = (two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 1].abs()
        bad = int(((a != ar) & ~near).sum())
        err = float((d2 - d2r).abs().max())
        print(
            f"kmeans_assign ({n}, {d}) x {k}: max |d2 - plain| {err:.3e}, "
            f"{int(near.sum())} near-tie points, {bad} other assignment mismatches"
        )
        if bad:
            raise AssertionError("kmeans_assign disagrees with its plain version")
        torch.testing.assert_close(d2, d2r, rtol=1e-4, atol=1e-5)
        if (n, d, k) in cases:
            worst = max(worst, err)
    return worst


def check_window(dev):
    from repro_torch.kernels.window_agg import window_agg, window_agg_ref

    cases = [(ROWS, 4, w, agg) for w in (8, 16) for agg in ("sum", "mean", "max")]
    cases += [(ROWS + 3, 4, 16, agg) for agg in ("sum", "mean", "max")]  # ragged S
    worst = 0.0
    for s, c, w, agg in cases:
        x = randn((s, c), s + w, dev)
        out = window_agg(x, window=w, agg=agg)
        torch.cuda.synchronize()
        ref = window_agg_ref(x, window=w, agg=agg)
        err = float((out - ref).abs().max())
        print(f"window_agg ({s}, {c}) w={w} {agg}: max |out - plain| {err:.3e}")
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        if s == ROWS and agg == "mean":
            worst = max(worst, err)
    return worst


# -- phase 4 -----------------------------------------------------------------


def expected_launches(sched):
    """Kernel launches the schedule implies for one instance."""
    from repro_torch.core.resources import FRONTEND

    on_device = {
        a.task for a in sched.assignments if sched.pool.pe(a.pe).location != FRONTEND
    }
    kmeans = 40 * ("sweep_clustering" in on_device)
    kmeans += 10 * ("kmeans" in on_device) + 20 * ("train_cluster" in on_device)
    window = ("window_agg" in on_device) + 2 * ("anomaly" in on_device)
    return {"kmeans_assign": kmeans, "window_agg": window}, len(on_device)


def _leaves(tree):
    import numpy as np

    from repro_torch import convert

    return [np.asarray(v) for v in convert.leaves(convert.to_numpy(tree))]


def compare_outputs(dev_rep, host_rep):
    """Every task's device-run output against the host-only run."""
    import numpy as np

    for name in sorted(host_rep.outputs):
        got = _leaves(dev_rep.outputs[name])
        want = _leaves(host_rep.outputs[name])
        if len(got) != len(want):
            raise AssertionError(f"{name}: output structure differs")
        for i, (u, v) in enumerate(zip(got, want, strict=True)):
            if u.shape != v.shape:
                raise AssertionError(f"{name}[{i}]: shape {u.shape} vs {v.shape}")
            if not np.isfinite(u.astype(np.float64)).all():
                raise AssertionError(f"{name}[{i}]: non-finite values")
            if u.ndim == 0 and np.issubdtype(v.dtype, np.integer):  # chosen k
                if int(u) != int(v):
                    raise AssertionError(f"{name}[{i}]: {int(u)} vs {int(v)}")
                continue
            close = np.isclose(u, v, rtol=1e-3, atol=1e-3)
            share = float(close.mean()) if close.size else 1.0
            # flags and assignments may flip where the host's float32 prefix
            # sums (or a near-tie distance) sit on the threshold
            exact = u.dtype.kind == "f" and name not in ("anomaly", "join")
            floor = 1.0 if exact else 0.9999
            if share < floor:
                raise AssertionError(f"{name}[{i}]: {share:.6f} of entries agree")
            if share < 1.0:
                print(f"  {name}[{i}]: {share:.6f} of {close.size} entries agree")


def run_pipeline(dev):
    from repro_torch import quickstart
    from repro_torch.kernels.kmeans import kmeans_assign
    from repro_torch.kernels.window_agg import window_agg

    kmeans_assign.launches = 0
    window_agg.launches = 0
    t0 = time.perf_counter()
    sched, reports = quickstart.run(device=dev, rows=ROWS, instances=INSTANCES)
    wall = time.perf_counter() - t0
    launches = {
        "kmeans_assign": kmeans_assign.launches,
        "window_agg": window_agg.launches,
    }
    print(f"pipeline: {INSTANCES} instances of {ROWS} x 8 in {wall:.3f} s wall")
    print(f"launches on the main path: {launches}")
    want, n_device = expected_launches(sched)
    if want != PER_INSTANCE:
        raise AssertionError(f"the EFT schedule implies {want} launches per instance")
    for name, n in PER_INSTANCE.items():
        if launches[name] != n * INSTANCES:
            got = launches[name]
            raise AssertionError(f"{name}: {got} launches, not {n * INSTANCES}")
    for rep in reports:
        if rep.by_backend != {"host": 16 - n_device, "device": n_device}:
            raise AssertionError(f"backends {rep.by_backend} differ from the schedule")
    _, host_reports = quickstart.run(
        device=dev, rows=ROWS, instances=INSTANCES, backend_of=lambda pe: "host"
    )
    for seed, (rep, host) in enumerate(zip(reports, host_reports, strict=True)):
        print(
            f"instance {seed}: {rep.wall_seconds:.3f} s wall, "
            f"host-only run {host.wall_seconds:.3f} s"
        )
        compare_outputs(rep, host)
    print("per-task seconds, first and last instance (ms):")
    for first, last in zip(reports[0].runs, reports[-1].runs, strict=True):
        print(
            f"  {first.task:17s} {first.pe:8s} {first.backend:6s} "
            f"{first.seconds * 1e3:10.3f} {last.seconds * 1e3:10.3f}"
        )
    return launches, [r.wall_seconds for r in reports]


# -- phase 5 -----------------------------------------------------------------


def graph_ms(calls, reps=20):
    """Device time of one pass over ``calls`` (closures), from CUDA-graph
    replays timed with CUDA events: the median of ``reps`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return sorted(times)[len(times) // 2]


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kmeans(dev):
    from repro_torch.kernels.kmeans import kmeans_assign, kmeans_assign_ref

    kernel, plain, nbytes, flops, n_calls = [], [], 0, 0, 0
    for n, d, k, reps in KMEANS_CALLS:
        x, c = randn((n, d), n + d, dev), randn((k, d), k, dev)
        kernel += [lambda x=x, c=c: kmeans_assign(x, c)] * reps
        plain += [lambda x=x, c=c: kmeans_assign_ref(x, c)] * reps
        nbytes += reps * 4 * (n * d + k * d + 2 * n)  # x, cent in; assign, min_d2 out
        flops += reps * 3 * n * k * d  # subtract, multiply, add
        n_calls += reps
    ms, plain_ms = graph_ms(kernel) / n_calls, graph_ms(plain) / n_calls
    return ms, plain_ms, bound(nbytes / n_calls, flops / n_calls)


def time_window(dev):
    from repro_torch.kernels.window_agg import window_agg, window_agg_ref

    kernel, plain, nbytes, flops, n_calls = [], [], 0, 0, 0
    for s, c, w, agg, reps in WINDOW_CALLS:
        x = randn((s, c), s + w, dev)
        kernel += [lambda x=x, w=w, agg=agg: window_agg(x, window=w, agg=agg)] * reps
        plain += [lambda x=x, w=w, agg=agg: window_agg_ref(x, window=w, agg=agg)] * reps
        nbytes += reps * 2 * 4 * s * c  # x in, out out
        flops += reps * s * c * w  # w adds per output (the mean's divide aside)
        n_calls += reps
    ms, plain_ms = graph_ms(kernel) / n_calls, graph_ms(plain) / n_calls
    return ms, plain_ms, bound(nbytes / n_calls, flops / n_calls)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase("1. card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")

    phase("2. build")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    names = sorted(p.name for p in built.values())
    print(f"built {names} in {time.perf_counter() - t0:.2f} s")

    phase("3. kernels vs plain versions")
    err = {"kmeans_assign": check_kmeans(dev), "window_agg": check_window(dev)}

    phase("4. main path")
    launches, walls = run_pipeline(dev)

    phase("5. timing")
    timing = {"kmeans_assign": time_kmeans(dev), "window_agg": time_window(dev)}
    meta = {
        "kmeans_assign": (
            "src/repro_torch/csrc/kmeans_assign.cu",
            "src/repro/kernels/kmeans/kmeans.py:47",
        ),
        "window_agg": (
            "src/repro_torch/csrc/window_agg.cu",
            "src/repro/kernels/window_agg/window_agg.py:74",
        ),
    }
    rows = []
    for name, (ms, plain_ms, (bound_ms, bound_by)) in timing.items():
        print(
            f"{name}: {ms * 1e3:.3f} us per launch (plain {plain_ms * 1e3:.3f} us, "
            f"bound {bound_ms * 1e3:.3f} us by {bound_by}), over one instance's calls"
        )
        rows.append(
            {
                "name": name,
                "route": "cuda",
                "source": meta[name][0],
                "replaces": meta[name][1],
                "launches": launches[name],
                "max_abs_err": err[name],
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
            }
        )
    print(f"pipeline wall per instance: {walls}")
    print(card)
    print(json.dumps({"kernels": rows}))
    count = torch.cuda.device_count()
    device = {"platform": "gpu", "kind": kind, "count": count}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
