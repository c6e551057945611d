"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card: its name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``, one
   process per source, all at once;
3. hold each kernel against its plain torch version at the main paths'
   shapes (bf16 within 2e-2, float32 within 2e-4). The attention kernels
   also run at gemma2-9b's head shape (D = 256, 16/8 heads, softcap 50)
   with a 512-token window that bites at S = 1536, at D = 72 and 100
   (not multiples of 16 or 8), on scattered decode masks with a whole
   cache split invalid, and at C = 2000 (not a multiple of the split);
   each case runs twice and must give bit-identical output, and an
   all-invalid decode row must be exactly 0. The DS kernels run at the
   path's shapes (window sums on x and on x*x) and at their edge cases:
   for k-means an x[1:] view 12 bytes past an aligned allocation, N % 4 =
   1, 2, 3, D = 1 and 4, K = 1 and K = 17 (just above the tiled kernel's
   templates), and the general kernel's shapes; for the window S not a
   multiple of a warp's 32-row chunk, S < w, C = 1, 3, 5, w = 33 and w = 1
   for every agg. Each runs twice (bit-identical), and max is exact. The
   inputs the JAX wrappers take beyond the path's: column slices (copied
   before launch), a window whose halo is over shared memory ((300, 1000)
   at w = 100: the global window kernel), head dim 288 for flash and
   decode (their wide kernels) and transposed attention inputs;
4. the DS path: compose a VDC on ``cuda:0``, schedule the paper's 16-task
   DS workload with EFT over ``paper_pool()``, and execute 3 instances of
   500,000 × 8 float32 rows (seeds 0, 1, 2) through the port's quickstart
   entry point. The k-means and window kernels' launch counts are read for
   this run alone, and every task's output is compared with the same
   pipeline run on the host backend only (placement must not change
   results);
5. the serving path: qwen3-0.6b at full width (28 layers, random weights
   from seed 0, bf16 activations) serves 16 requests (prompts of 128–1536
   tokens, 32–96 new tokens) through the port's ``ServeEngine`` with 8
   slots, a 2048-token cache and the EFT admission rule. The attention
   kernels' launch counts are read for this run alone and must equal 28
   per prefill and 28 per decode tick. The same trace is served again
   with the plain attention. In bf16 the prefill logits of the two runs
   may part by no more than twice what the plain version parts from
   itself in another order of summation (rounding in 28 bf16 layers puts
   that spread above 2e-2). The trace is then served with float32
   compute, kernels and plain: there prefill logits agree within 2e-4 and
   token streams up to each request's first near tie (top two plain
   logits within 2e-4);
6. time each kernel over its calls on its path (CUDA graph, CUDA events),
   beside its plain version, the least time the card could take (its
   bound) and, for the attention kernels, PyTorch's
   ``scaled_dot_product_attention`` on the same inputs. For the attention
   kernels also their achieved TFLOP/s and GB/s, registers, shared memory
   and spilled bytes (``cudaFuncGetAttributes``), the HGMMA and HMMA
   instructions in the flash library's SASS (``cuobjdump``, where the
   toolkit has it: a library without HGMMA fails the run), and the flash
   kernel's share of the prefill time. For the DS kernels their GB/s, the
   registers, static shared memory and spills of every kernel instance
   the path launches (a spill fails the run), and at one path shape a
   graph of one call beside 20 back-to-back calls (the graph's own
   launch). Every kernel's line gives its share of its bound. Then the
   kernels' variants off the main path (the global window kernel, the
   wide flash and decode kernels at D = 288), each beside its plain
   version and its bound;
7. the gateway path: the port's ``ServingGateway`` plans a 64-request
   trace (``synth_requests(64, seed=0, mean_gap=0.2)``, prompts of the
   trace's bucket lengths with tokens from numpy's default_rng(0)) on
   the host, 8 slots, and its plan must equal the reference gateway's:
   the pinned assignment digest, completions, sheds, preemptions,
   goodput, makespan and kept tokens (``tests/test_torch_gateway.py``
   holds the pins to the JAX package, which this machine lacks). The
   plan is replayed through ``ServingGateway.serve`` into a
   ``ServeEngine`` on the card (qwen3-0.6b at full width, phase 5's
   weights, fcfs in plan order): the engine must admit the requests in
   plan order, finish every kept request with ``max_new_tokens + 1``
   tokens, and the attention kernels' launches, counted for this run
   alone, must equal 28 per prefill and 28 per decode tick. The plan's
   first 8 requests are served again with plain attention: bf16 prefill
   logits within twice phase 5's plain spread, and in float32 compute
   (kernels and plain) logits within 2e-4 and token streams equal up to
   each request's first near tie.

Prints the card line, JSON lines of the attention and DS kernels' reports
and one JSON line of kernel results before the last line, which is
``{"ok": true, "device": {...}}``. In that line, the DS kernels' launches
are phase 4's and the attention kernels' phase 7's (phase 5's are printed
above it). Exits non-zero, printing no result, when there is no CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

ROWS = 500_000
INSTANCES = 3
#: H100 SXM data sheet: HBM3 bytes/s, float32 FLOP/s outside the tensor
#: cores, bf16 dense tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
#: the kernels' calls in one pipeline instance under the EFT schedule:
#: sweep_clustering (k = 2, 3, 4, 6 on the 2 PCA columns, 10 steps each),
#: train_cluster (k = 4 on the 3 filtered columns, 20 steps); window_agg
#: (w = 8) and anomaly's two rolling means (w = 16) on 4 columns
KMEANS_CALLS = [(ROWS, 2, k, 10) for k in (2, 3, 4, 6)] + [(ROWS, 3, 4, 20)]
WINDOW_CALLS = [(ROWS, 4, 8, "mean", 1), (ROWS, 4, 16, "mean", 2)]
PER_INSTANCE = {"kmeans_assign": 60, "window_agg": 3}
#: the serving path: arch, engine, trace size; bf16 tolerance of
#: tests/test_kernels.py:17
SERVE_ARCH = "qwen3-0.6b"
SERVE_ENGINE = {"max_batch": 8, "max_seq": 2048, "policy": "eft"}
SERVE_REQUESTS = 16
BF16_TOL = 2e-2
F32_TOL = 2e-4
#: the gateway path (phase 7): the engine and gateway of
#: benchmarks/bench_gateway.py's smoke setup at 8 slots, the trace size,
#: and the plan the reference gateway makes of it (held to the JAX package
#: by tests/test_torch_gateway.py)
GATEWAY_ENGINE = {
    "policy": "fcfs",
    "max_batch": 8,
    "max_seq": 2048,
    "prefill_cost_per_tok": 2e-4,
    "decode_cost_per_tok": 0.02,
}
GATEWAY = {
    "window_s": 2.0,
    "shed_backlog_s": 3.0,
    "preempt_backlog_s": 2.0,
    "max_preempt_probes_per_window": 4,
}
GATEWAY_REQUESTS = 64
GATEWAY_PINS = {
    "digest": "84902bc58607d19a7d892c5ee6e6c15eaaf444125ce5a50cbc7fb5b5abde778c",
    "n_completed": 60,
    "n_shed": 4,
    "n_preemptions": 6,
    "goodput": 0.9614691740562925,
    "makespan": 24.65756299404881,
    "prompt_tokens": 6624,
    "decode_tokens": 4016,
}
#: requests of the plan served again with plain attention
GATEWAY_CHECKED = 8
#: the variants' shapes: the window over shared memory, head dim 288
WIDE_WINDOW = (300, 1000, 100)
WIDE_HEAD_DIM = 288


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


def _kmeans_case(x, c, label):
    """The k-means kernel against its plain version on (x, c), twice: the
    two runs must be bit-identical. Returns the largest |min_d2| deviation."""
    from repro_torch.kernels.kmeans import kmeans_assign, kmeans_assign_ref
    from repro_torch.kernels.kmeans.ops import kmeans_plan
    from repro_torch.kernels.kmeans.ref import kmeans_distances

    (n, d), k = x.shape, c.shape[0]
    plan = kmeans_plan(n, d, k, x.data_ptr())
    a, d2 = kmeans_assign(x, c)
    again = kmeans_assign(x, c)
    torch.cuda.synchronize()
    ar, d2r = kmeans_assign_ref(x, c)
    if k > 1:
        two = kmeans_distances(x, c).topk(2, dim=1, largest=False).values
        near = (two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 1].abs()
    else:
        near = torch.zeros_like(a, dtype=torch.bool)
    bad = int(((a != ar) & ~near).sum())
    err = float((d2 - d2r).abs().max())
    print(
        f"kmeans_assign {label} ({n}, {d}) x {k} [{plan.variant}"
        f"{'' if plan.variant == 'general' else ', 16-byte loads' if plan.vector else ', 4-byte loads'}]: "
        f"max |d2 - plain| {err:.3e}, {int(near.sum())} near-tie points, "
        f"{bad} other assignment mismatches"
    )
    if bad:
        raise AssertionError("kmeans_assign disagrees with its plain version")
    torch.testing.assert_close(d2, d2r, rtol=1e-4, atol=1e-5)
    if not (torch.equal(a, again[0]) and torch.equal(d2, again[1])):
        raise AssertionError(f"kmeans_assign {label}: two runs differ")
    return err


def check_kmeans(dev):
    """The path's five shapes (the tiled kernel), its edge cases (an x[1:]
    view 12 bytes past an aligned allocation, N % 4 = 1, 2, 3, D = 1 and 4,
    K = 1 and K = 17, just above the templates), and the general kernel's
    staged and uncached centroids."""
    worst = 0.0
    for n, d, k, _ in KMEANS_CALLS:
        x, c = randn((n, d), n + d, dev), randn((k, d), k, dev)
        worst = max(worst, _kmeans_case(x, c, "path"))
    edges = [(ROWS, 3, 4, 1)] + [(ROWS + r, 2, 6, 0) for r in (1, 2, 3)]
    edges += [(ROWS, 1, 5, 0), (ROWS, 4, 5, 0), (10_000, 3, 1, 0), (10_000, 3, 17, 0)]
    edges += [(4097, 64, 300, 0), (1000, 13_000, 3, 0)]  # centroid chunks; uncached
    for n, d, k, offset in edges:
        x = randn((n + offset, d), n + d, dev)[offset:]
        label = f"x[{offset}:]" if offset else "edge"
        _kmeans_case(x, randn((k, d), k, dev), label)
    _kmeans_case(randn((ROWS, 8), 8, dev)[:, :2], randn((6, 2), 6, dev), "x[:, :2]")
    return worst


def _window_case(x, w, agg, label):
    """The window kernel against its plain version, twice (bit-identical
    runs); max must be exact. Returns the largest deviation."""
    from repro_torch.kernels.window_agg import window_agg, window_agg_ref
    from repro_torch.kernels.window_agg.ops import window_plan

    s, c = x.shape
    plan = window_plan(s, c, w, agg, x.data_ptr())
    out = window_agg(x, window=w, agg=agg)
    again = window_agg(x, window=w, agg=agg)
    torch.cuda.synchronize()
    ref = window_agg_ref(x, window=w, agg=agg)
    err = float((out - ref).abs().max())
    print(f"window_agg {label} ({s}, {c}) w={w} {agg} [{plan.variant}]: max |out - plain| {err:.3e}")
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    if agg == "max" and err != 0:
        raise AssertionError(f"window_agg {label}: max is not exact")
    if not torch.equal(out, again):
        raise AssertionError(f"window_agg {label}: two runs differ")
    return err


def check_window(dev):
    """The path's shapes on x and on x*x (anomaly's second moment) for
    every agg (the scan kernel), and edge cases: S not a multiple of 32 or
    of a block's 1,024 rows, S < w, C = 1, 3, 5 and w = 33 (the general
    kernel), and w = 1."""
    worst = 0.0
    for w in (8, 16):
        x = randn((ROWS, 4), ROWS + w, dev)
        for agg in ("sum", "mean", "max"):
            err = _window_case(x, w, agg, "path")
            _window_case(x * x, w, agg, "path, x*x")
            if agg == "mean":
                worst = max(worst, err)
    edges = [(ROWS + 3, 4, 16), (1007, 4, 8), (5, 4, 16), (3000, 4, 1), (3000, 4, 33)]
    edges += [(3000, c, 8) for c in (1, 3, 5)] + [(3000, 3, 1)]
    for s, c, w in edges:
        x = randn((s, c), s + w, dev)
        for agg in ("sum", "mean", "max"):
            _window_case(x, w, agg, "edge")
    s, c, w = WIDE_WINDOW
    x, cols = randn((s, c), s, dev), randn((ROWS, 8), 4, dev)[:, :4]
    for agg in ("sum", "mean", "max"):
        _window_case(x, w, agg, "halo over shared memory")
        _window_case(cols, 8, agg, "x[:, :4]")
    return worst


def serve_cfg():
    from repro_torch.configs import get_config

    return get_config(SERVE_ARCH)


def serve_trace(cfg):
    """The serving trace: (prompt, max_new_tokens, arrival) per request,
    from numpy's default_rng(0); prompt tokens uniform in [2, vocab)."""
    rng = np.random.default_rng(0)
    trace = []
    for i in range(SERVE_REQUESTS):
        plen = int(rng.integers(128, 1537))
        prompt = rng.integers(2, cfg.vocab_size, size=plen).astype(np.int32)
        trace.append((prompt, int(rng.integers(32, 97)), i * 0.25))
    return trace


def attention_shapes(cfg, trace):
    """The attention kernels' shapes on the serving path: the prompt
    lengths (flash, B = 1), and a decode valid mask of the engine's
    (max_batch, max_seq) cache with each slot holding one of the first
    requests halfway through its new tokens."""
    lens = [len(p) for p, _, _ in trace]
    b, c = SERVE_ENGINE["max_batch"], SERVE_ENGINE["max_seq"]
    filled = [len(p) + n // 2 for p, n, _ in trace[:b]]
    valid = torch.arange(c)[None] < torch.tensor(filled)[:, None]
    return lens, valid


def attention_inputs(cfg, s, seed, dev, b=1, c=None):
    dt = getattr(torch, cfg.dtype)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if c is None:  # prefill: q (1, S, Hq, D), k/v (1, S, Hkv, D)
        shapes = [(b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)]
    else:  # decode: q (B, Hq, D), k/v (B, C, Hkv, D)
        shapes = [(b, hq, d), (b, c, hkv, d), (b, c, hkv, d)]
    return [randn(sh, seed + i, dev).to(dt) for i, sh in enumerate(shapes)]


def _flash_case(q, k, v, label, **kw):
    """The flash kernel against its plain version on (q, k, v), twice: the
    two runs must be bit-identical. Returns the largest deviation."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    out = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
    ref = ref.transpose(1, 2)
    err = float((out.float() - ref.float()).abs().max())
    print(f"flash_attention {label} {tuple(q.shape)} {q.dtype}: max |out - plain| {err:.3e}")
    tol = BF16_TOL if q.dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    if not torch.equal(out, again):
        raise AssertionError(f"flash_attention {label}: two runs differ")
    return err


def check_flash(dev, cfg, lens):
    """The serving path's prompt lengths (bf16, and float32 as phase 5's
    float32 run takes them), gemma2-9b's head shape (D = 256, 16/8 heads,
    softcap 50) with a 512-token window that bites at S = 1536, and head
    dims that are not multiples of 16 (72: TMA's zero fill) or 8 (100: the
    wrapper's padding)."""
    worst = 0.0
    for s in sorted({min(lens), sorted(lens)[len(lens) // 2], max(lens), 1}):
        q, k, v = attention_inputs(cfg, s, s, dev)
        worst = max(worst, _flash_case(q, k, v, f"S={s}", causal=True))
        f32 = [t.float() for t in (q, k, v)]
        _flash_case(*f32, f"S={s}", causal=True)
    g2 = dataclasses.replace(cfg, n_heads=16, n_kv_heads=8, head_dim=256)
    q, k, v = attention_inputs(g2, 1536, 5, dev)
    _flash_case(q, k, v, "gemma2-9b heads, window 512", causal=True, window=512, softcap=50.0)
    for d in (72, 100):
        q, k, v = attention_inputs(dataclasses.replace(cfg, head_dim=d), 829, d, dev)
        _flash_case(q, k, v, f"D={d}", causal=True)
    wide = dataclasses.replace(cfg, head_dim=WIDE_HEAD_DIM)
    q, k, v = attention_inputs(wide, 300, 11, dev)
    _flash_case(q, k, v, f"D={WIDE_HEAD_DIM} (wide)", causal=True, window=128, softcap=30.0)
    _flash_case(*(t.float() for t in (q, k, v)), f"D={WIDE_HEAD_DIM} (wide)", causal=True)
    q, k, v = attention_inputs(cfg, 829, 12, dev)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)  # (B, S, H, D) strides of (B, H, S, D)
    _flash_case(qt, k, v, "transposed q", causal=True)
    return worst


def _decode_case(q, k, v, valid, label):
    """The decode kernels against their plain version, twice (bit-identical
    runs); an all-invalid row must be exactly 0."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref

    out = decode_attention(q, k, v, valid)
    again = decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    ref = decode_attention_ref(q, k, v, valid)
    err = float((out.float() - ref.float()).abs().max())
    print(
        f"decode_attention {label} {tuple(k.shape)} {q.dtype}, {int(valid.sum())} valid "
        f"slots: max |out - plain| {err:.3e}"
    )
    tol = BF16_TOL if q.dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    if not torch.equal(out, again):
        raise AssertionError(f"decode_attention {label}: two runs differ")
    empty = ~valid.any(1)
    if empty.any() and out[empty].abs().max() != 0:
        raise AssertionError(f"decode_attention {label}: an all-invalid row is not 0")
    return err


def check_decode(dev, cfg, valid):
    """The serving path's mask (bf16 and float32), the same with row 0 all
    invalid, scattered (non-prefix) valid slots with a whole split invalid
    in every row, and C = 2000, not a multiple of the split."""
    from repro_torch.kernels.decode_attention import split_plan

    b, c = valid.shape
    q, k, v = attention_inputs(cfg, 1, 7, dev, b=b, c=c)
    valid = valid.to(dev)
    empty = valid.clone()
    empty[0] = False  # a row with no valid slot gives 0
    worst = 0.0
    for mask, label in ((valid, "serving mask"), (empty, "row 0 empty")):
        worst = max(worst, _decode_case(q, k, v, mask, label))
        _decode_case(*(t.float() for t in (q, k, v)), mask, label)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, split = split_plan(b, cfg.n_kv_heads, c, n_sm)
    print(f"decode split plan at ({b}, {cfg.n_kv_heads}, {c}): {n_split} splits of {split}")
    g = torch.Generator(device="cpu").manual_seed(3)
    scattered = torch.rand((b, c), generator=g) > 0.5
    scattered[:, split : 2 * split] = False
    scattered[0] = False
    _decode_case(q, k, v, scattered.to(dev), "scattered, split 1 empty")
    c2 = 2000
    q2, k2, v2 = attention_inputs(cfg, 1, 9, dev, b=b, c=c2)
    ragged = (torch.rand((b, c2), generator=g) > 0.3).to(dev)
    _decode_case(q2, k2, v2, ragged, f"C={c2}")
    wide = dataclasses.replace(cfg, head_dim=WIDE_HEAD_DIM)
    qw, kw, vw = attention_inputs(wide, 1, 13, dev, b=b, c=c)
    _decode_case(qw, kw, vw, scattered.to(dev), f"D={WIDE_HEAD_DIM} (wide), scattered")
    _decode_case(*(t.float() for t in (qw, kw, vw)), empty, f"D={WIDE_HEAD_DIM} (wide)")
    kt = k.transpose(1, 2).contiguous().transpose(1, 2)  # a (B, Hkv, C, D) cache's view
    _decode_case(q, kt, v, valid, "transposed k")
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


def _top2_gap(logits):
    top = logits.float().topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).cpu()


class ServeRun:
    """Serves the trace through a ``ServeEngine`` (phase 5's, or
    ``engine``, which a caller may fill itself) and records, besides the
    engine's own bookkeeping, each prefill's and decode tick's host time
    (the card synchronised), the order of admissions, every request's
    prefill logits, and per emitted token the gap between the two largest
    logits behind it. Requests get ``rids``, by default their trace
    positions."""

    def __init__(self, cfg, params, trace, plain, engine=None, rids=None):
        from repro_torch.serve import EngineConfig, RequestSpec, ServeEngine

        if engine is None:
            engine = ServeEngine(
                cfg, params, EngineConfig(**SERVE_ENGINE, plain_attention=plain)
            )
        self.eng = engine
        rids = range(len(trace)) if rids is None else rids
        for rid, (prompt, n_new, arrival) in zip(rids, trace, strict=True):
            self.eng.submit(
                RequestSpec(rid=rid, prompt=prompt, max_new_tokens=n_new, arrival=arrival)
            )
        self.prefill_s = self.decode_s = 0.0
        self.prefill_tokens = self.decode_ticks = 0
        self.prefill_logits, self.gaps = {}, defaultdict(list)
        self.admitted = []
        self._last = None
        prefill, decode, step = self.eng._prefill, self.eng._decode, self.eng.step

        def timed_prefill(params, tokens, caches):
            t0 = time.perf_counter()
            logits, caches = prefill(params, tokens, caches)
            torch.cuda.synchronize()
            self.prefill_s += time.perf_counter() - t0
            self.prefill_tokens += tokens.shape[1]
            self._last = logits[0]
            return logits, caches

        def timed_decode(params, tok, pos, caches):
            t0 = time.perf_counter()
            nxt, logits, caches = decode(params, tok, pos, caches)
            torch.cuda.synchronize()
            self.decode_s += time.perf_counter() - t0
            self.decode_ticks += 1
            gap = _top2_gap(logits)
            for b, r in enumerate(self.eng.slots):
                if r is not None:
                    self.gaps[r.rid].append(float(gap[b]))
            return nxt, logits, caches

        def recorded_step():
            out = step()
            rid = out["admitted"]
            if rid is not None:  # its prefill ran this tick, before the decode
                self.admitted.append(rid)
                self.prefill_logits[rid] = self._last.float().cpu()
                self.gaps[rid].insert(0, float(_top2_gap(self._last)))
            return out

        self.eng._prefill, self.eng._decode = timed_prefill, timed_decode
        self.eng.step = recorded_step

    def run(self, max_ticks=100_000):
        eng = self.eng
        t0 = time.perf_counter()
        while (eng.queue or any(s is not None for s in eng.slots)) and eng.ticks < max_ticks:
            eng.step()
        return self.finish(time.perf_counter() - t0)

    def finish(self, wall):
        """Read the engine's records after a run of ``wall`` host seconds."""
        self.wall = wall
        self.done = {r.rid: r for r in self.eng.finished}
        self.ticks, self.latency = self.eng.ticks, self.eng.latency_stats()
        return self


def run_serving(dev, cfg, trace):
    from repro_torch import convert
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import model as M

    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init(cfg, gen, dev)
    n_params = sum(t.numel() for t in convert.leaves(params))
    print(f"{cfg.name}: {n_params} parameters ({cfg.param_dtype} masters, {cfg.dtype} compute)")
    for plain in (False, True):  # warm-up: cuBLAS handles, allocator, kernels
        ServeRun(cfg, params, [(trace[0][0][:128], 4, 0.0)], plain).run()
    torch.cuda.synchronize()

    flash_attention.launches = decode_attention.launches = 0
    main = ServeRun(cfg, params, trace, plain=False).run()
    launches = {
        "flash_attention": flash_attention.launches,
        "decode_attention": decode_attention.launches,
    }
    print(f"launches on the serving path: {launches}")
    want = {
        "flash_attention": cfg.n_layers * len(main.prefill_logits),
        "decode_attention": cfg.n_layers * main.decode_ticks,
    }
    if launches != want:
        raise AssertionError(f"the trace implies {want} launches, the run made {launches}")
    main.eng = None  # free its cache before the next run
    tick = profile_decode(cfg, params, trace)
    plain = ServeRun(cfg, params, trace, plain=True).run()
    plain.eng = None
    check_lengths(main, len(trace))
    check_lengths(plain, len(trace))

    # bf16: the kernels' order of summation against the plain version's,
    # beside the plain version against itself in another order (its KV
    # chunk at 128, not 1024): rounding to bf16 in 28 layers parts two
    # orders of the same sums by more than 2e-2 in the logits
    spread = plain_spread(cfg, params, trace, plain.prefill_logits)
    err = compare_runs(main, plain, None)
    print(
        f"bf16: max |prefill logits, kernels - plain| {max(err):.3e}; "
        f"the plain version in two orders of summation: {max(spread):.3e}"
    )
    if max(err) > 2 * max(spread):
        raise AssertionError("bf16 kernel logits part from plain beyond twice its own spread")

    # float32 compute, same weights and trace: within the float32 tolerance
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    runs32 = [ServeRun(cfg32, params, trace, plain=p).run() for p in (False, True)]
    for r in runs32:
        r.eng = None
        check_lengths(r, len(trace))
    err32 = compare_runs(*runs32, F32_TOL)
    print(f"float32: max |prefill logits, kernels - plain| {max(err32):.3e} (bound {F32_TOL})")

    stats = {}
    for name, r in (("kernels", main), ("plain", plain)):
        tokens = sum(len(q.output) for q in r.done.values())
        stats[name] = {
            "wall_s": r.wall,
            "prefill_ms_per_token": r.prefill_s * 1e3 / r.prefill_tokens,
            "decode_ms_per_tick": r.decode_s * 1e3 / r.decode_ticks,
            "tokens_per_s": tokens / r.wall,
            "prefills": len(r.prefill_logits),
            "decode_ticks": r.decode_ticks,
            "tokens": tokens,
            "engine_ticks": r.ticks,
        }
        print(f"serving ({name} attention): {json.dumps(stats[name])}")
    print(f"engine latency stats: {json.dumps(main.latency)}")
    stats["decode_tick_profile"] = tick
    errs = {"bf16": max(err), "bf16_plain_spread": max(spread), "float32": max(err32)}
    return launches, stats, errs, params


def profile_decode(cfg, params, trace, ticks=3):
    """Decode ticks at a full batch (8 slots): host ms per tick (no
    profiler), then under ``torch.profiler`` the kernels launched and the
    device time per tick, by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b = SERVE_ENGINE["max_batch"]
    run = ServeRun(cfg, params, [(p, 64, 0.0) for p, _, _ in trace[:b]], plain=False)
    eng = run.eng
    while any(s is None for s in eng.slots):
        eng.step()  # admit all requests, one prefill a tick
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / ticks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / ticks
    launches = sum(e.count for e in kernels) / ticks
    print(
        f"decode tick at batch {b}: {host_ms:.3f} ms on the host clock; under the "
        f"profiler {launches:.0f} kernels and {device_ms:.3f} ms of device time a "
        f"tick, so the card idles {1 - device_ms / host_ms:.1%} of the tick"
    )
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        ms = e.self_device_time_total / 1e3 / ticks
        print(f"  {ms:8.3f} ms/tick {e.count // ticks:5d} launches/tick  {e.key[:90]}")
    return {"host_ms": host_ms, "device_ms": device_ms, "kernels_per_tick": launches}


def check_lengths(run, n_requests):
    """Every one of ``n_requests`` finished, with its ``max_new_tokens + 1``
    tokens and finite prefill logits."""
    if len(run.done) != n_requests:
        raise AssertionError(f"{len(run.done)} requests finished, not {n_requests}")
    for rid, r in run.done.items():
        if len(r.output) != r.max_new_tokens + 1:
            raise AssertionError(
                f"request {rid}: {len(r.output)} tokens, not {r.max_new_tokens + 1}"
            )
        if not torch.isfinite(run.prefill_logits[rid]).all():
            raise AssertionError(f"request {rid}: prefill logits not finite")


def compare_runs(kern, plain, tol):
    """Per request of the plain run: the largest prefill-logit difference,
    and the token position up to which the streams agree beside the first
    position where the plain run's top two logits lie within ``tol`` (a
    near tie). With a ``tol``, logits must agree within it and the streams
    up to the first near tie."""
    errs = []
    for rid in sorted(plain.done):
        prompt = plain.done[rid].prompt
        got, ref = kern.done[rid].output, plain.done[rid].output
        logits, ref_logits = kern.prefill_logits[rid], plain.prefill_logits[rid]
        errs.append(float((logits - ref_logits).abs().max()))
        near_tol = BF16_TOL if tol is None else tol
        near = next((i for i, g in enumerate(plain.gaps[rid]) if g <= near_tol), len(got))
        agree = next((i for i, (a, b) in enumerate(zip(got, ref, strict=True)) if a != b), len(got))
        print(
            f"  request {rid}: prompt {len(prompt)}, {len(got)} tokens, prefill logits "
            f"max |kernels - plain| {errs[-1]:.3e}, first near tie (gap <= {near_tol}) "
            f"at {near}, streams agree up to {agree}"
        )
        if tol is not None:
            torch.testing.assert_close(logits, ref_logits, rtol=tol, atol=tol)
            if agree < near:
                raise AssertionError(f"request {rid}: streams part at {agree} before a near tie")
    return errs


def plain_spread(cfg, params, trace, logits):
    """Per request: the plain version's prefill logits with another KV chunk
    (another order of the same f32 sums) against ``logits``."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    other = dataclasses.replace(cfg, attn_chunk=128)
    cast = M.cast_params(cfg, params)
    out = []
    for rid, (prompt, _, _) in enumerate(trace):
        toks = torch.as_tensor(prompt, device=cast["final_norm"]["scale"].device)[None]
        caches = T.init_caches(other, 1, SERVE_ENGINE["max_seq"], device=toks.device)
        got, _ = M.prefill(other, cast, toks, caches, plain_attention=True)
        out.append(float((got[0].float().cpu() - logits[rid]).abs().max()))
    return out


# -- phase 7 -----------------------------------------------------------------


def gateway_trace(synth_requests, request_spec, vocab):
    """The gateway trace: ``synth_requests(64, seed=0, mean_gap=0.2)`` of a
    package, each prompt an int32 array of its bucket length with tokens
    uniform in [2, vocab) from numpy's default_rng(0). The plan reads
    prompt lengths only, so the arrays leave it as the bare counts make it."""
    rng = np.random.default_rng(0)
    out = []
    for s in synth_requests(GATEWAY_REQUESTS, seed=0, mean_gap=0.2):
        prompt = rng.integers(2, vocab, size=s.prompt_len).astype(np.int32)
        out.append(
            request_spec(
                rid=s.rid,
                prompt=prompt,
                max_new_tokens=s.max_new_tokens,
                arrival=s.arrival,
                tier=s.tier,
                curve=s.curve,
            )
        )
    return out


def gateway_pins(gw, report):
    """The planned run's numbers that :data:`GATEWAY_PINS` holds."""
    kept = [gw.specs[rid] for _, rid in gw.plan_order()]
    return {
        "digest": report.digest,
        "n_completed": report.n_completed,
        "n_shed": report.n_shed,
        "n_preemptions": report.n_preemptions,
        "goodput": report.goodput,
        "makespan": report.makespan,
        "prompt_tokens": sum(s.prompt_len for s in kept),
        "decode_tokens": sum(s.max_new_tokens for s in kept),
    }


def run_gateway(dev, cfg, params, bf16_spread):
    """Plan the gateway trace on the host, hold the plan to its pins,
    replay it on the card through the kernels, and serve the plan's first
    requests again with plain attention (bf16, then float32 compute)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serve import (
        EngineConfig,
        GatewayConfig,
        RequestSpec,
        ServeEngine,
        ServingGateway,
        synth_requests,
    )

    ecfg = EngineConfig(**GATEWAY_ENGINE)
    specs = gateway_trace(synth_requests, RequestSpec, cfg.vocab_size)
    t0 = time.perf_counter()
    gw = ServingGateway(GatewayConfig(ecfg=ecfg, **GATEWAY))
    report = gw.run(specs)
    plan_s = time.perf_counter() - t0
    pins = gateway_pins(gw, report)
    attainment = {tier: row["attainment"] for tier, row in report.per_tier.items()}
    print(
        f"gateway plan: {len(specs)} requests planned in {plan_s:.3f} s on the host; "
        f"{report.n_completed} kept, {report.n_shed} shed, {report.n_preemptions} "
        f"preemptions, goodput {report.goodput:.4f}, makespan {report.makespan:.4f}; "
        f"attainment {json.dumps(attainment)}; {pins['prompt_tokens']} prompt and "
        f"{pins['decode_tokens']} decode tokens kept"
    )
    if pins != GATEWAY_PINS:
        raise AssertionError(f"the gateway's plan {pins} is not the pinned {GATEWAY_PINS}")
    order = [rid for _, rid in gw.plan_order()]

    run = ServeRun(cfg, params, [], plain=False, engine=ServeEngine(cfg, params, ecfg))
    flash_attention.launches = decode_attention.launches = 0
    t0 = time.perf_counter()
    stats = gw.serve(run.eng)
    run.finish(time.perf_counter() - t0)
    launches = {
        "flash_attention": flash_attention.launches,
        "decode_attention": decode_attention.launches,
    }
    print(f"launches on the gateway path: {launches}")
    if run.admitted != order:
        raise AssertionError("the engine did not admit the requests in plan order")
    if stats["n"] != report.n_completed:
        raise AssertionError(f"the engine finished {stats['n']}, the plan kept {report.n_completed}")
    check_lengths(run, len(order))
    want = {
        "flash_attention": cfg.n_layers * len(run.admitted),
        "decode_attention": cfg.n_layers * run.decode_ticks,
    }
    if launches != want:
        raise AssertionError(f"the replay implies {want} launches, the run made {launches}")
    tokens = sum(len(r.output) for r in run.done.values())
    replay = {
        "plan_s": plan_s,
        "wall_s": run.wall,
        "prefills": len(run.admitted),
        "decode_ticks": run.decode_ticks,
        "engine_ticks": run.ticks,
        "tokens": tokens,
        "prefill_ms_per_token": run.prefill_s * 1e3 / run.prefill_tokens,
        "decode_ms_per_tick": run.decode_s * 1e3 / run.decode_ticks,
        "tokens_per_s": tokens / run.wall,
        "goodput": report.goodput,
        "n_shed": report.n_shed,
        "n_preemptions": report.n_preemptions,
        "attainment": attainment,
    }
    print(f"gateway replay: {json.dumps(replay)}")
    print(f"engine latency stats: {json.dumps(run.latency)}")

    # the plan's first requests again with plain attention, at their plan
    # ranks; rows of the batch are computed independently, so each one's
    # stream does not depend on its neighbours
    first = order[:GATEWAY_CHECKED]
    trace = [(gw.specs[rid].prompt, gw.specs[rid].max_new_tokens, float(i)) for i, rid in enumerate(first)]
    run.eng = None
    plain = ServeRun(cfg, params, trace, plain=True, engine=ServeEngine(
        cfg, params, dataclasses.replace(ecfg, plain_attention=True)), rids=first).run()
    plain.eng = None
    check_lengths(plain, len(first))
    err = compare_runs(run, plain, None)
    print(
        f"gateway, bf16: max |prefill logits, kernels - plain| {max(err):.3e} over the "
        f"plan's first {len(first)} requests (bound: twice phase 5's plain spread, "
        f"{2 * bf16_spread:.3e})"
    )
    if max(err) > 2 * bf16_spread:
        raise AssertionError("gateway bf16 kernel logits part from plain beyond twice its spread")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    at_once = [(p, n, 0.0) for p, n, _ in trace]
    runs32 = []
    for p in (False, True):
        eng = ServeEngine(cfg32, params, dataclasses.replace(ecfg, plain_attention=p))
        r = ServeRun(cfg32, params, at_once, plain=p, engine=eng, rids=first).run()
        r.eng = None
        check_lengths(r, len(first))
        runs32.append(r)
    err32 = compare_runs(*runs32, F32_TOL)
    print(f"gateway, float32: max |prefill logits, kernels - plain| {max(err32):.3e} (bound {F32_TOL})")
    return launches, replay, {"bf16": max(err), "float32": max(err32)}


# -- phase 6 -----------------------------------------------------------------


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


def bound(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
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
    work = {"bytes": nbytes / n_calls, "flops": flops / n_calls}
    return ms, plain_ms, bound(nbytes / n_calls, flops / n_calls), work


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
    work = {"bytes": nbytes / n_calls, "flops": flops / n_calls}
    return ms, plain_ms, bound(nbytes / n_calls, flops / n_calls), work


def time_flash(dev, cfg, lens):
    """One call per prompt length of the trace (the path makes 28 of each)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    kernel, plain, library, nbytes, flops = [], [], [], 0, 0
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for s in lens:
        q, k, v = attention_inputs(cfg, s, s, dev)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        kernel.append(lambda q=q, k=k, v=v: flash_attention(q, k, v, causal=True))
        plain.append(lambda q=qt, k=kt, v=vt: flash_attention_ref(q, k, v, causal=True))
        library.append(
            lambda q=qt, k=kt, v=vt: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True
            )
        )
        nbytes += 2 * s * d * (2 * hq + 2 * hkv)  # q, k, v in; out out (bf16)
        flops += 2 * hq * s * s * d  # the causal half of q k^T and of p v
    n = len(lens)
    times = [graph_ms(calls) / n for calls in (kernel, plain, library)]
    work = {"bytes": nbytes / n, "flops": flops / n}
    return (*times, bound(nbytes / n, flops / n, BF16_FLOP_PER_S), work)


def time_decode(dev, cfg, valid):
    """The calls of one engine tick at the path's decode shape: one per
    layer, each over its own layer's cache, so every call finds the cache
    cold in L2 as the engine does (a 2048-slot cache is 67 MB, and its
    valid part alone 29.6 MB of the 50 MB L2). Per launch."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref

    b, c = valid.shape
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(7)
    layers = [
        [torch.randn(sh, generator=gen, device=dev, dtype=dt) for sh in ((b, hq, d), (b, c, hkv, d), (b, c, hkv, d))]
        for _ in range(cfg.n_layers)
    ]
    valid = valid.to(dev)
    mask = valid[:, None, None, :]
    kernel = [lambda q=q, k=k, v=v: decode_attention(q, k, v, valid) for q, k, v in layers]
    plain = [lambda q=q, k=k, v=v: decode_attention_ref(q, k, v, valid) for q, k, v in layers]
    library = [
        lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True
        )
        for q, k, v in layers
    ]
    n_valid = int(valid.sum())  # the kernel reads the K and V rows of valid slots only
    nbytes = 2 * (2 * b * hq * d + 2 * n_valid * hkv * d) + b * c  # + the valid bytes
    flops = 4 * n_valid * hq * d
    times = [graph_ms(calls) / len(layers) for calls in (kernel, plain, library)]
    del layers
    return (*times, bound(nbytes, flops, BF16_FLOP_PER_S), {"bytes": nbytes, "flops": flops})


def sass_counts(name):
    """HGMMA (wgmma) and HMMA (mma.sync) instructions in the SASS of the
    built library of ``csrc/<name>.cu``, or None without cuobjdump."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run(
        [tool, "-sass", str(_build.library_path(name))],
        capture_output=True,
        text=True,
        check=True,
        timeout=300,
    ).stdout
    return {op: sass.count(op) for op in ("HGMMA", "HMMA")}  # "HMMA" is not in "HGMMA"


def ds_report(dev, timing, work):
    """Per DS kernel: achieved GB/s and share of its bound over the path's
    calls, and the registers, static shared memory and spills of each
    kernel instance those calls launch (the path's tensors are fresh
    allocations, so 16-byte aligned). Besides, at one path shape, the time
    of a graph that holds one call and the time a call over 20
    back-to-back calls: their difference is the graph's own launch, which
    a pass over few calls (window_agg's 3) carries in its time a launch."""
    from repro_torch.kernels.kmeans import kmeans_assign
    from repro_torch.kernels.kmeans.ops import kernel_attributes as kmeans_attrs
    from repro_torch.kernels.kmeans.ops import kmeans_plan
    from repro_torch.kernels.window_agg import window_agg
    from repro_torch.kernels.window_agg.ops import kernel_attributes as window_attrs
    from repro_torch.kernels.window_agg.ops import window_plan

    x2, c4 = randn((ROWS, 2), 1, dev), randn((4, 2), 2, dev)
    x4 = randn((ROWS, 4), 3, dev)
    alone = {
        "kmeans_assign": ("(500000, 2) x 4", lambda: kmeans_assign(x2, c4)),
        "window_agg": ("(500000, 4) w=16 mean", lambda: window_agg(x4, window=16, agg="mean")),
    }

    aligned = 1 << 20
    instances = {"kmeans_assign": {}, "window_agg": {}}
    for n, d, k, _ in KMEANS_CALLS:
        plan = kmeans_plan(n, d, k, aligned)
        instances["kmeans_assign"][f"{plan.variant} D={d} kmax={plan.kmax}"] = kmeans_attrs(plan, d)
    for s, c, w, agg, _ in WINDOW_CALLS:
        plan = window_plan(s, c, w, agg, aligned)
        instances["window_agg"][f"{plan.variant} {agg}"] = window_attrs(plan, agg)
    report = {}
    for name, kernels in instances.items():
        ms, _, (bound_ms, _), _ = timing[name]
        shape, call = alone[name]
        report[name] = {
            "us": ms * 1e3,
            "bound_us": bound_ms * 1e3,
            "share_of_bound": bound_ms / ms,
            "gb_per_s": work[name]["bytes"] / ms / 1e6,
            "one_call_graph_us": graph_ms([call]) * 1e3,
            "back_to_back_us": graph_ms([call] * 20) / 20 * 1e3,
            "kernels": kernels,
        }
        print(
            f"{name}: {ms * 1e3:.3f} us per launch (bound {bound_ms * 1e3:.3f} us, "
            f"{bound_ms / ms:.1%} of it); {report[name]['gb_per_s']:.1f} GB/s; at {shape} "
            f"a graph of one call {report[name]['one_call_graph_us']:.3f} us, "
            f"{report[name]['back_to_back_us']:.3f} us a call over 20 back-to-back; "
            + "; ".join(
                f"{key}: {a['registers']} registers, {a['static_smem']} B static shared "
                f"memory, {a['local_bytes']} B spilled"
                for key, a in kernels.items()
            )
        )
        if any(a["local_bytes"] for a in kernels.values()):
            raise AssertionError(f"{name}: a kernel of the path spills")
    return report


def attention_report(cfg, timing, work):
    """Per attention kernel: achieved rate against the card's peak, its
    registers, shared memory and spills at the serving shape and, for
    flash, the tensor-core instructions in its SASS."""
    from repro_torch.kernels.decode_attention.ops import kernel_attributes as decode_attrs
    from repro_torch.kernels.flash_attention.ops import kernel_attributes as flash_attrs

    dt = getattr(torch, cfg.dtype)
    g = cfg.n_heads // cfg.n_kv_heads
    report = {}
    for name, attrs in (
        ("flash_attention", flash_attrs(dt, cfg.head_dim)),
        ("decode_attention", decode_attrs(dt, cfg.head_dim, g)),
    ):
        ms, _, (bound_ms, _), library_ms = timing[name]
        row = {
            "us": ms * 1e3,
            "library_us": library_ms * 1e3,
            "bound_us": bound_ms * 1e3,
            "share_of_bound": bound_ms / ms,
            "tflop_per_s": work[name]["flops"] / ms / 1e9,
            "gb_per_s": work[name]["bytes"] / ms / 1e6,
            **attrs,
        }
        if name == "flash_attention":
            row["sass"] = sass_counts(name)
        report[name] = row
        print(
            f"{name}: {row['us']:.3f} us per launch (library {row['library_us']:.3f} us, "
            f"bound {row['bound_us']:.3f} us, {row['share_of_bound']:.1%} of it); "
            f"{row['tflop_per_s']:.1f} TFLOP/s, {row['gb_per_s']:.1f} GB/s; "
            f"{attrs['registers']} registers, {attrs['dynamic_smem'] + attrs['static_smem']} B "
            f"shared memory a block, {attrs['local_bytes']} B spilled"
            + (f"; SASS {row['sass']}" if name == "flash_attention" else "")
        )
    if report["flash_attention"]["sass"] is not None and not report["flash_attention"]["sass"]["HGMMA"]:
        raise AssertionError("the flash library has no HGMMA: the bf16 kernel is off the tensor cores")
    return report


def time_variants(dev, cfg, valid):
    """The kernels' variants off the main path, at phase 3's shapes: the
    global window kernel on (300, 1000) at w = 100 (mean), and the wide
    flash (S = 300, causal) and decode (the serving mask) kernels at
    D = 288 in bf16 with qwen3-0.6b's 16/8 heads. Per launch over 10
    back-to-back calls in a graph, beside the plain version and the bound
    (bytes in and out once; for attention the bf16 tensor-core rate)."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.window_agg import window_agg, window_agg_ref

    s, c, w = WIDE_WINDOW
    x = randn((s, c), s, dev)
    wide = dataclasses.replace(cfg, head_dim=WIDE_HEAD_DIM)
    hq, hkv, d = wide.n_heads, wide.n_kv_heads, WIDE_HEAD_DIM
    q, k, v = attention_inputs(wide, 300, 11, dev)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    b, cache = valid.shape
    qd, kd, vd = attention_inputs(wide, 1, 13, dev, b=b, c=cache)
    mask = valid.to(dev)
    n_valid = int(valid.sum())
    cases = {
        "window_agg global (300, 1000) w=100 mean": (
            lambda: window_agg(x, window=w, agg="mean"),
            lambda: window_agg_ref(x, window=w, agg="mean"),
            bound(2 * 4 * s * c, s * c * w),
        ),
        f"flash_attention wide S=300 D={d} bf16": (
            lambda: flash_attention(q, k, v, causal=True),
            lambda: flash_attention_ref(qt, kt, vt, causal=True),
            bound(2 * 300 * d * (2 * hq + 2 * hkv), 2 * hq * 300 * 300 * d, BF16_FLOP_PER_S),
        ),
        f"decode_attention wide (8, 2048) D={d} bf16": (
            lambda: decode_attention(qd, kd, vd, mask),
            lambda: decode_attention_ref(qd, kd, vd, mask),
            bound(
                2 * (2 * b * hq * d + 2 * n_valid * hkv * d) + b * cache,
                4 * n_valid * hq * d,
                BF16_FLOP_PER_S,
            ),
        ),
    }
    out = {}
    for name, (kernel, plain, (bound_ms, bound_by)) in cases.items():
        ms = graph_ms([kernel] * 10) / 10
        plain_ms = graph_ms([plain] * 10) / 10
        out[name] = {
            "us": ms * 1e3,
            "plain_us": plain_ms * 1e3,
            "bound_us": bound_ms * 1e3,
            "bound_by": bound_by,
            "share_of_bound": bound_ms / ms,
        }
        print(
            f"{name}: {ms * 1e3:.3f} us per launch (plain {plain_ms * 1e3:.3f} us, bound "
            f"{bound_ms * 1e3:.3f} us by {bound_by}, {bound_ms / ms:.1%} of it)"
        )
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

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
    cfg = serve_cfg()
    trace = serve_trace(cfg)
    lens, valid = attention_shapes(cfg, trace)
    err = {
        "kmeans_assign": check_kmeans(dev),
        "window_agg": check_window(dev),
        "flash_attention": check_flash(dev, cfg, lens),
        "decode_attention": check_decode(dev, cfg, valid),
    }

    phase("4. DS path")
    launches, walls = run_pipeline(dev)

    phase("5. serving path")
    t0 = time.perf_counter()
    serve_launches, serve_stats, serve_err, params = run_serving(dev, cfg, trace)
    print(f"serving phase: {time.perf_counter() - t0:.3f} s")

    phase("6. timing")
    km_ms, km_plain, km_bound, km_work = time_kmeans(dev)
    win_ms, win_plain, win_bound, win_work = time_window(dev)
    timing = {
        "kmeans_assign": (km_ms, km_plain, km_bound, None),
        "window_agg": (win_ms, win_plain, win_bound, None),
    }
    ds = ds_report(dev, timing, {"kmeans_assign": km_work, "window_agg": win_work})
    flash_ms, flash_plain, flash_lib, flash_bound, flash_work = time_flash(dev, cfg, lens)
    timing["flash_attention"] = (flash_ms, flash_plain, flash_bound, flash_lib)
    dec_ms, dec_plain, dec_lib, dec_bound, dec_work = time_decode(dev, cfg, valid)
    timing["decode_attention"] = (dec_ms, dec_plain, dec_bound, dec_lib)
    attn = attention_report(cfg, timing, {"flash_attention": flash_work, "decode_attention": dec_work})
    # the flash kernel's share of prefill: its device time over the trace's
    # prompts (28 launches each) against the prefills' host time
    kern = serve_stats["kernels"]
    prefill_ms = kern["prefill_ms_per_token"] * sum(lens)
    flash_total = flash_ms * len(lens) * cfg.n_layers
    print(
        f"prefill: flash_attention {flash_total:.3f} ms of device time over the trace's "
        f"prompts, {flash_total / prefill_ms:.1%} of the {prefill_ms:.3f} ms of prefill"
    )
    print(f"attention kernels: {json.dumps(attn)}")
    print(f"DS kernels: {json.dumps(ds)}")
    variants = time_variants(dev, cfg, valid)
    print(f"kernel variants off the main path: {json.dumps(variants)}")

    phase("7. gateway path")
    t0 = time.perf_counter()
    gateway_launches, gateway_stats, gateway_err = run_gateway(
        dev, cfg, params, serve_err["bf16_plain_spread"]
    )
    launches.update(gateway_launches)
    del params
    print(f"gateway phase: {time.perf_counter() - t0:.3f} s")
    meta = {
        "kmeans_assign": (
            "src/repro_torch/csrc/kmeans_assign.cu",
            "src/repro/kernels/kmeans/kmeans.py:47",
        ),
        "window_agg": (
            "src/repro_torch/csrc/window_agg.cu",
            "src/repro/kernels/window_agg/window_agg.py:74",
        ),
        "flash_attention": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:112",
        ),
        "decode_attention": (
            "src/repro_torch/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/decode_attention.py:81",
        ),
    }
    rows = []
    for name, (ms, plain_ms, (bound_ms, bound_by), library_ms) in timing.items():
        lib = "" if library_ms is None else f", library {library_ms * 1e3:.3f} us"
        print(
            f"{name}: {ms * 1e3:.3f} us per launch (plain {plain_ms * 1e3:.3f} us{lib}, "
            f"bound {bound_ms * 1e3:.3f} us by {bound_by}, {bound_ms / ms:.1%} of it), "
            f"over its path's calls"
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
                "library_ms": library_ms,
            }
        )
    print(f"pipeline wall per instance: {walls}")
    print(f"serving: {json.dumps(serve_stats)}")
    print(f"serving, max |prefill logits, kernels - plain|: {json.dumps(serve_err)}")
    print(f"serving launches (phase 5): {json.dumps(serve_launches)}")
    print(f"gateway: {json.dumps(gateway_stats)}")
    print(f"gateway, max |prefill logits, kernels - plain|: {json.dumps(gateway_err)}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    count = torch.cuda.device_count()
    device = {"platform": "gpu", "kind": kind, "count": count}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
