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
   each request's first near tie;
8. the jamba-v0.1 path: one 8-layer period of jamba-v0.1-52b at full
   width (7 Mamba layers, 1 NoPE attention layer, 4 MoE layers of 16
   experts, top-2; 13.3 B parameters, drawn in bf16 from seed 0) serves
   8 requests (prompts of 32-256 tokens, 4-16 new tokens; numpy's
   default_rng(1)) through the port's ``ServeEngine`` with 8 slots and a
   512-token cache. The attention kernels' launches, read for this run
   alone, must equal one per prefill and one per decode tick for each
   attention layer, and be nonzero. The trace is served again with plain
   attention (bf16 prefill logits within twice the plain version's own
   spread in another KV chunk), then its first 2 requests with float32
   weights and compute, kernels and plain (logits within 2e-4, streams
   equal up to the first near tie). Prints the decode ms a tick, the
   tokens/s, a profiled tick and the tick's bound from the bytes it must
   read;
9. the llama-3.2-vision path: llama-3.2-vision-11b at full width and depth
   (40 layers, 8 of them cross-attention over 1600 patch embeddings from
   the frontend stub, passed as ``ServeEngine(..., vision=...)``), with
   phase 8's trace, engine and checks;
10. the training path: the flash kernel at the training shape (8 × 1024
   tokens, 16/8 heads of 128) against its plain version, forward and
   ``FlashAttentionFn``'s gradients (bf16 2e-2, float32 2e-4); then
   qwen3-0.6b at full width and depth (f32 masters from seed 0, bf16
   compute) trained 20 steps through the port's ``Trainer`` with remat:
   AdamW (lr 1e-3, 2 warmup steps), the port's ``TokenBatchLoader``
   (batch 8, 1024 tokens, the full vocab, 256 documents, seed 0), a
   checkpoint every 10 steps into a temporary directory and one worker
   death at step 15, which restores step 10. Its flash launches, counted
   for this run alone, must be 56 a step (remat runs each block's forward
   twice); the loss must fall; the final checkpoint must restore bit for
   bit. Prints ms a step (median after the first), tokens a second, model
   FLOPs a step and their share of 989 TFLOP/s (``train_mfu``), peak
   memory, a profiled step and the losses at steps 1 and 20. Then one
   batch's loss and gradients without remat, kernels against plain
   attention: in bf16 the per-token losses within twice the plain path's
   own spread over other KV chunks (128, 256, 512) and every gradient
   leaf within 2e-2 of its largest magnitude; in float32 compute the loss
   and every leaf within 2e-4. Last, at the training shape, the flash
   kernel's time beside its plain version, the library and its bound,
   and the backward it takes (the plain version's) beside the library's;
11. the distributed serving path: 4 ranks of one gloo group on the one
   card (NCCL refuses two ranks on one GPU), spawned after the build,
   sharing the weights through CUDA IPC. (a) qwen3-0.6b at full width
   under ``strategy_for(cfg, 1 x 4 data x model mesh,
   decode_flash_shard=True)``: caches of 2048 slots, 512 a rank; phase
   5's first 8 requests prefilled (flash kernel) one per cache row, then
   32 ticks of ``M.decode_step`` whose attention runs
   ``sharded_decode_attention`` (each rank's stats over its slots, one
   all-reduce MAX and two SUM a layer). Held, tick by tick on the same
   fed tokens, to the same run on one rank without rules (the decode
   kernel): float32 logits within 2e-3, bf16 within twice phase 5's
   plain spread, greedy tokens equal up to the first near tie; each
   rank's slots must be a quarter of the whole cache's bytes. (b) one
   MoE layer at jamba-v0.1's widths (16 experts, top-2, FF 14336) from
   seed 0, EP over the 4 ranks (4 experts each), x of 8 x 256 tokens:
   float32 y within 2e-4 of max |y| of ``apply_moe_spmd`` with all 16
   experts on one rank, its aux terms within 1e-5; ms a bf16 call both
   ways. (c) one qwen3-0.6b block's gradients (15.7 M float32 elements a
   rank, ``default_rng(rank)``): ``hierarchical_psum`` on a 2 (pod) x 2
   (data) mesh equals a flat all-reduce within 1e-5 relative,
   ``int8_allreduce`` over data = 4 is within 2 % of the mean with a
   non-zero residual, and a world-1 NCCL group returns its input. Each
   sub-phase prints its numbers beside the card line.

Prints the card line, JSON lines of the attention and DS kernels' reports
and one JSON line of kernel results before the last line, which is
``{"ok": true, "device": {...}}``. In that line, the DS kernels' launches
are phase 4's and the attention kernels' the sum over phases 5, 7, 8, 9,
10 and 11 (each phase's are printed above it; phase 11's are its ranks'
and its 1-rank run's); flash's deviation is the largest of phases 3 and
10. Exits non-zero, printing no result, when there is no CUDA card.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import tempfile
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
#: phases 8 and 9: MoE, Mamba and cross-attention blocks at full width.
#: arch → depth: jamba-v0.1 is cut to one 8-layer period (its 32 layers'
#: 103 GB of bf16 weights do not fit one 80 GB card); llama-3.2-vision
#: keeps its 40 layers
BLOCK_MODELS = {"jamba-v0.1-52b": 8, "llama-3.2-vision-11b": None}
BLOCK_ENGINE = {"max_batch": 8, "max_seq": 512, "policy": "eft"}
BLOCK_REQUESTS = 8
#: the float32 run's requests (jamba's float32 weights are 53 GB)
BLOCK_FLOAT32_REQUESTS = 2
#: the plain version's other KV chunk for the bf16 spread: prompts are
#: 32-256 tokens, so every longer one is summed in another order
BLOCK_SPREAD_CHUNK = 32
#: phase 10: qwen3-0.6b trained at full width through the port's Trainer:
#: AdamW, the loader's batches of 8 x 1024 tokens, remat, a checkpoint
#: every 10 steps and one worker death at step 15 (restores step 10)
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_OPT = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 20}
TRAIN_LOADER = {"batch_size": 8, "seq_len": 1024, "vocab_size": 151936, "n_docs": 256, "seed": 0}
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 20, 10, 15
#: the plain path's other KV chunks: its own spread in other orders of summation
TRAIN_SPREAD_CHUNKS = (128, 256, 512)
#: bf16 gradients, kernels against plain: the largest deviation of a leaf
#: relative to its largest magnitude (tests/test_kernels.py:17's bf16
#: tolerance, ~2.5 bf16 ulps: every gradient passes bf16 activations)
TRAIN_BF16_GRAD_TOL = 2e-2


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

        def timed_prefill(params, tokens, caches, vision=None):
            t0 = time.perf_counter()
            logits, caches = prefill(params, tokens, caches, vision=vision)
            torch.cuda.synchronize()
            self.prefill_s += time.perf_counter() - t0
            self.prefill_tokens += tokens.shape[1]
            self._last = logits[0]
            return logits, caches

        def timed_decode(params, tok, pos, caches, vision=None):
            t0 = time.perf_counter()
            nxt, logits, caches = decode(params, tok, pos, caches, vision=vision)
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
        stats[name] = run_stats(r)
        print(f"serving ({name} attention): {json.dumps(stats[name])}")
    print(f"engine latency stats: {json.dumps(main.latency)}")
    stats["decode_tick_profile"] = tick
    errs = {"bf16": max(err), "bf16_plain_spread": max(spread), "float32": max(err32)}
    return launches, stats, errs, params


def run_stats(r):
    """A finished ``ServeRun``'s serving numbers (host clock, card
    synchronised)."""
    tokens = sum(len(q.output) for q in r.done.values())
    return {
        "wall_s": r.wall,
        "prefill_ms_per_token": r.prefill_s * 1e3 / r.prefill_tokens,
        "decode_ms_per_tick": r.decode_s * 1e3 / r.decode_ticks,
        "tokens_per_s": tokens / r.wall,
        "prefills": len(r.prefill_logits),
        "decode_ticks": r.decode_ticks,
        "tokens": tokens,
        "engine_ticks": r.ticks,
    }


def profile_decode(cfg, params, trace, ticks=3, engine=None, new_tokens=64):
    """Decode ticks at a full batch (8 slots): host ms per tick (no
    profiler), then under ``torch.profiler`` the kernels launched and the
    device time per tick, by kernel. ``engine``, when given, is the
    engine to fill (phase 5's by default)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b = SERVE_ENGINE["max_batch"] if engine is None else engine.ecfg.max_batch
    run = ServeRun(
        cfg, params, [(p, new_tokens, 0.0) for p, _, _ in trace[:b]], plain=False, engine=engine
    )
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


def plain_spread(cfg, params, trace, logits, chunk=128, max_seq=None, vision=None):
    """Per request: the plain version's prefill logits with another KV chunk
    (``chunk``: another order of the same f32 sums) against ``logits``.
    ``vision`` is what the engine's prefill passes the cross-attention
    blocks."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.serve.serve_step import serve_config

    # the engine's config: MoE capacity widened at serve time
    other = dataclasses.replace(serve_config(cfg), attn_chunk=chunk)
    cast = M.cast_params(cfg, params)
    max_seq = max_seq or SERVE_ENGINE["max_seq"]
    out = []
    for rid, (prompt, _, _) in enumerate(trace):
        toks = torch.as_tensor(prompt, device=cast["final_norm"]["scale"].device)[None]
        caches = T.init_caches(other, 1, max_seq, device=toks.device)
        got, _ = M.prefill(other, cast, toks, caches, vision=vision, plain_attention=True)
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


# -- phases 8 and 9 ------------------------------------------------------------


def free_card():
    """Return freed tensors to the card: an engine whose ``step`` a
    ``ServeRun`` wrapped holds itself (and its weights) in a reference
    cycle, which only the cyclic collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def block_cfg(arch):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    depth = BLOCK_MODELS[arch]
    return cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)


def block_trace(cfg):
    """(prompt, max_new_tokens, arrival) per request, from numpy's
    default_rng(1): prompts of 32-256 tokens, 4-16 new tokens."""
    rng = np.random.default_rng(1)
    trace = []
    for i in range(BLOCK_REQUESTS):
        prompt = rng.integers(2, cfg.vocab_size, size=int(rng.integers(32, 257))).astype(np.int32)
        trace.append((prompt, int(rng.integers(4, 17)), i * 0.25))
    return trace


def self_attention_layers(cfg):
    """The layers that launch flash at prefill and decode at decode."""
    return sum(cfg.block_spec(i).mixer in ("attn", "local") for i in range(cfg.n_layers))


def decode_tick_bytes(cfg, params, vision, caches):
    """Bytes one decode tick must read at least: every weight (the dense
    MoE dispatch runs every expert; the embedding table only gives its
    rows, unless it is also the head), the patch embeddings and the
    caches, each once."""
    from repro_torch import convert

    total = sum(t.numel() * t.element_size() for t in convert.leaves(params))
    if not cfg.tie_embeddings:
        emb = params["embed"]["embedding"]
        total -= emb.numel() * emb.element_size()
    total += sum(t.numel() * t.element_size() for t in convert.leaves(caches))
    if vision is not None:
        total += vision.numel() * vision.element_size()
    return total


def run_block_model(dev, arch):
    """Serve the arch at full width through the port's ``ServeEngine``:
    bf16 weights and compute, with the kernels and then with plain
    attention (prefill logits within twice the plain version's own spread),
    then float32 weights and compute on the first requests (logits within
    2e-4, streams up to the first near tie). The attention kernels'
    launches are read for the bf16 kernel run alone."""
    from repro_torch import convert
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import frontends
    from repro_torch.models import model as M
    from repro_torch.serve import EngineConfig, ServeEngine

    cfg = block_cfg(arch)
    trace = block_trace(cfg)
    n_attn = self_attention_layers(cfg)
    vision = None
    if cfg.family == "vlm":
        vision = torch.as_tensor(frontends.fake_patch_embeddings(cfg, 1)[0], device=dev)
    ecfg = EngineConfig(**BLOCK_ENGINE)

    def engine(c, params, plain):
        return ServeEngine(c, params, dataclasses.replace(ecfg, plain_attention=plain), vision=vision)

    # bf16 masters: a float32 copy beside them would not fit beside jamba's
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    t0 = time.perf_counter()
    params = M.init(cfg16, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in convert.leaves(params))
    specs = [cfg.block_spec(i) for i in range(cfg.n_layers)]
    print(
        f"{cfg.name}: {cfg.n_layers} layers ({sum(s.mixer == 'mamba' for s in specs)} Mamba, "
        f"{n_attn} attention, {sum(s.mixer == 'xattn' for s in specs)} cross-attention, "
        f"{sum(s.moe for s in specs)} MoE), {n_params} parameters in bf16, drawn in "
        f"{time.perf_counter() - t0:.3f} s"
    )
    for plain in (False, True):  # warm-up
        ServeRun(cfg16, params, [(trace[0][0][:32], 2, 0.0)], plain, engine=engine(cfg16, params, plain)).run()
    torch.cuda.synchronize()

    flash_attention.launches = decode_attention.launches = 0
    main = ServeRun(cfg16, params, trace, plain=False, engine=engine(cfg16, params, False)).run()
    launches = {
        "flash_attention": flash_attention.launches,
        "decode_attention": decode_attention.launches,
    }
    print(f"launches on the {cfg.name} path: {launches}")
    want = {
        "flash_attention": n_attn * len(main.prefill_logits),
        "decode_attention": n_attn * main.decode_ticks,
    }
    if launches != want or not all(launches.values()):
        raise AssertionError(f"the trace implies {want} launches, the run made {launches}")
    check_lengths(main, len(trace))
    tick_bytes = decode_tick_bytes(cfg16, params, vision, main.eng.caches)
    main.eng = None
    tick = profile_decode(cfg16, params, trace, engine=engine(cfg16, params, False), new_tokens=16)
    plain = ServeRun(cfg16, params, trace, plain=True, engine=engine(cfg16, params, True)).run()
    plain.eng = None
    check_lengths(plain, len(trace))
    prefill_vision = None if vision is None else vision[None, 0][None]
    spread = plain_spread(
        cfg16,
        params,
        trace,
        plain.prefill_logits,
        chunk=BLOCK_SPREAD_CHUNK,
        max_seq=BLOCK_ENGINE["max_seq"],
        vision=prefill_vision,
    )
    err = compare_runs(main, plain, None)
    print(
        f"{cfg.name}, bf16: max |prefill logits, kernels - plain| {max(err):.3e}; "
        f"the plain version in two orders of summation: {max(spread):.3e}"
    )
    if max(err) > 2 * max(spread):
        raise AssertionError(f"{cfg.name}: bf16 kernel logits part from plain beyond twice its spread")
    stats = {}
    for name, r in (("kernels", main), ("plain", plain)):
        stats[name] = run_stats(r)
        print(f"{cfg.name} serving ({name} attention): {json.dumps(stats[name])}")
    bound_ms = tick_bytes / HBM_BYTES_PER_S * 1e3
    print(
        f"{cfg.name} decode tick: {stats['kernels']['decode_ms_per_tick']:.3f} ms on the host "
        f"clock; bound from the {tick_bytes} bytes it must read: {bound_ms:.3f} ms"
    )
    stats["decode_tick_profile"] = tick
    stats["decode_tick_bytes"] = tick_bytes
    stats["decode_tick_bound_ms"] = bound_ms
    del params, main, plain
    free_card()

    # float32 weights and compute on the first requests
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params = M.init(cfg32, torch.Generator(device=dev).manual_seed(0), dev)
    few = [(p, n, 0.0) for p, n, _ in trace[:BLOCK_FLOAT32_REQUESTS]]
    runs32 = []
    for p in (False, True):
        r = ServeRun(cfg32, params, few, plain=p, engine=engine(cfg32, params, p)).run()
        r.eng = None
        check_lengths(r, len(few))
        runs32.append(r)
    err32 = compare_runs(*runs32, F32_TOL)
    print(f"{cfg.name}, float32: max |prefill logits, kernels - plain| {max(err32):.3e} (bound {F32_TOL})")
    del params, runs32
    free_card()
    errs = {"bf16": max(err), "bf16_plain_spread": max(spread), "float32": max(err32)}
    return launches, stats, errs


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


# -- phase 10 ----------------------------------------------------------------


def train_cfg():
    from repro_torch.configs import get_config

    return get_config(TRAIN_ARCH)


def block_weights(cfg):
    """Weights every product of a block reads, and the tied head's."""
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) + 3 * d * cfg.d_ff
    return cfg.n_layers * per_layer, d * cfg.vocab_size


def attention_fwd_flops(cfg, b, s):
    """The causal half of q k^T and p v, every layer: 2·S²·D a head."""
    return cfg.n_layers * b * cfg.n_heads * 2 * s * s * cfg.head_dim


def train_flops(cfg, b, s, remat):
    """Model FLOPs of one step: 6·N·tokens for the products (N: the
    blocks' weights and the tied head), attention's forward and its
    backward (twice the forward), and with remat the blocks' forward once
    more (2·N_blocks·tokens and attention's forward)."""
    blocks, head = block_weights(cfg)
    attn = attention_fwd_flops(cfg, b, s)
    flops = 6 * (blocks + head) * b * s + 3 * attn
    if remat:
        flops += 2 * blocks * b * s + attn
    return flops


def check_train_flash(dev, cfg):
    """The flash kernel at the training shape (B = 8, S = 1024, 16/8
    heads of 128) in bf16 and float32: forward against the plain version
    (twice, bit-identical), and the q, k, v gradients of
    ``FlashAttentionFn`` against autograd through ``chunked_attention``
    (bf16 2e-2, float32 2e-4). Returns the largest forward deviation."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.layers import chunked_attention

    b, s = TRAIN_LOADER["batch_size"], TRAIN_LOADER["seq_len"]
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (t.to(dt) for t in attention_inputs(cfg, s, 21, dev, b=b))
        err = _flash_case(q, k, v, "training shape", causal=True)
        worst = max(worst, err) if dt == torch.bfloat16 else worst
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        gout = randn(q.shape, 25, dev).to(dt)
        got = torch.autograd.grad(flash_attention(*leaves), leaves, gout)
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        ref = chunked_attention(*leaves, q_positions=pos, kv_positions=pos)
        want = torch.autograd.grad(ref, leaves, gout)
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        gerr = max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want, strict=True))
        print(f"flash_attention training shape {dt}: max |grad - plain grad| {gerr:.3e}")
        for a, w in zip(got, want, strict=True):
            torch.testing.assert_close(a, w, rtol=tol, atol=tol)
    return worst


def _median_event_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def time_train_attention(dev, cfg):
    """At the training shape, one layer: the flash kernel's forward (graph
    of 4 calls), its plain version and ``scaled_dot_product_attention``,
    the bound; and the backward that ``FlashAttentionFn`` takes (the plain
    ``chunked_attention`` recomputed and differentiated) beside the
    library's backward (CUDA events, median of 5)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    b, s = TRAIN_LOADER["batch_size"], TRAIN_LOADER["seq_len"]
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = attention_inputs(cfg, s, 31, dev, b=b)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    ms = graph_ms([lambda: flash_attention(q, k, v)] * 4) / 4
    plain_ms = graph_ms([lambda: flash_attention_ref(qt, kt, vt)] * 4) / 4
    library_ms = graph_ms(
        [lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)] * 4
    ) / 4
    nbytes = 2 * b * s * d * (2 * hq + 2 * hkv)
    flops = attention_fwd_flops(cfg, b, s) // cfg.n_layers
    bound_ms, bound_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    gout = randn(q.shape, 35, dev).to(q.dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves)
    bwd_ms = _median_event_ms(lambda: torch.autograd.grad(out, leaves, gout, retain_graph=True))
    lt = [t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lt, is_causal=True, enable_gqa=True)
    lib_bwd_ms = _median_event_ms(
        lambda: torch.autograd.grad(lib_out, lt, gout.transpose(1, 2), retain_graph=True)
    )
    row = {
        "shape": [b, s, hq, hkv, d],
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "backward_ms": bwd_ms,
        "library_backward_ms": lib_bwd_ms,
    }
    print(
        f"flash_attention at the training shape {row['shape']} bf16: {ms:.3f} ms a launch "
        f"(plain {plain_ms:.3f}, library {library_ms:.3f}, bound {bound_ms:.3f} ms by "
        f"{bound_by}, {bound_ms / ms:.1%} of it); its backward through the plain version "
        f"{bwd_ms:.3f} ms a layer (library backward {lib_bwd_ms:.3f} ms)"
    )
    return row


def run_training(dev, cfg):
    """The Trainer on the card: TRAIN_STEPS steps with remat, a checkpoint
    every TRAIN_CKPT_EVERY steps and a worker death at TRAIN_FAIL_AT.
    Returns the flash launches of the run and its numbers; also checks
    that the final checkpoint restores bit for bit."""
    from repro_torch.data.loader import LoaderConfig, Prefetcher, TokenBatchLoader
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.train.fault_tolerance import FailureEvent, FailureInjector
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.train.tree import flatten_with_path

    b, s = TRAIN_LOADER["batch_size"], TRAIN_LOADER["seq_len"]
    injector = FailureInjector([FailureEvent(step=TRAIN_FAIL_AT, worker="w1", kind="die")])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        tcfg = TrainerConfig(
            n_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY, ckpt_dir=ckpt_dir,
            log_every=5, remat=True, seed=0,
        )
        data = Prefetcher(TokenBatchLoader(LoaderConfig(**TRAIN_LOADER)))
        trainer = Trainer(cfg, OptConfig(**TRAIN_OPT), tcfg, data, injector=injector, device=dev)
        n_params = sum(t.numel() for _, t in flatten_with_path(trainer.state["params"]))
        print(f"{cfg.name}: {n_params} parameters ({cfg.param_dtype} masters, {cfg.dtype} compute)")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        out = trainer.train()
        wall = time.perf_counter() - t0
        launches = flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        hist, acts = out["history"], out["recovery_log"]
        losses = [h["loss"] for h in hist]
        step_s = sorted(h["step_time_s"] for h in hist[1:])[len(hist[1:]) // 2]
        flops = train_flops(cfg, b, s, remat=True)
        stats = {
            "steps_run": len(hist),
            "ms_per_step": step_s * 1e3,
            "first_step_ms": hist[0]["step_time_s"] * 1e3,
            "tokens_per_s": b * s / step_s,
            "model_flops_per_step": flops,
            "train_mfu": flops / step_s / BF16_FLOP_PER_S,
            "peak_memory_bytes": peak,
            "flash_launches_per_step": launches / len(hist),
            "loss_step_1": losses[0],
            "loss_step_20": losses[-1],
            "restarts": out["restarts"],
            "restored_step": acts[0].restored_step if acts else None,
            "wall_s": wall,
        }
        print(f"training: {json.dumps(stats)}")
        if launches != 2 * cfg.n_layers * len(hist):
            raise AssertionError(f"{launches} flash launches over {len(hist)} steps, not 56 a step")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"the loss did not fall: {losses}")
        if out["restarts"] != 1 or acts[0].restored_step != TRAIN_CKPT_EVERY:
            raise AssertionError(f"expected one restart from step {TRAIN_CKPT_EVERY}: {acts}")
        if hist[-1]["step"] != TRAIN_STEPS:
            raise AssertionError(f"training ended at step {hist[-1]['step']}")

        prof = profile_train_step(trainer, next(data))
        prof["idle_share"] = 1 - prof["device_ms"] / stats["ms_per_step"]
        print(f"the card idles {prof['idle_share']:.1%} of the median step ({stats['ms_per_step']:.3f} ms)")
        stats["step_profile"] = prof

        # checkpoint round trip: the final checkpoint against the final state
        t0 = time.perf_counter()
        back = trainer.ckpt.restore(trainer.state, step=TRAIN_STEPS)
        pairs = zip(flatten_with_path(back), flatten_with_path(trainer.state), strict=True)
        for (key, a), (_, w) in pairs:
            if a.dtype != w.dtype or not torch.equal(a, w):
                raise AssertionError(f"checkpoint round trip: {key} differs")
        stats["restore_s"] = time.perf_counter() - t0
        print(f"checkpoint round trip: {len(flatten_with_path(back))} leaves bit-equal, restored in {stats['restore_s']:.3f} s")
        del trainer, back, data
    free_card()
    return {"flash_attention": launches}, stats


def profile_train_step(trainer, batch):
    """One more step of ``trainer`` (its step function on its state) under
    ``torch.profiler``: device time by kernel and launches. The state is
    not advanced."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.train_step import to_device

    batch = to_device(batch, trainer.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metrics = trainer.step_fn(trainer.state, batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(
        f"training step under the profiler: {host_ms:.3f} ms on the host clock, {launches} "
        f"kernels, {device_ms:.3f} ms of device time"
    )
    top = []
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        ms = e.self_device_time_total / 1e3
        top.append({"kernel": e.key[:90], "ms": ms, "launches": e.count})
        print(f"  {ms:9.3f} ms {e.count:6d} launches  {e.key[:90]}")
    del metrics
    return {"host_ms": host_ms, "device_ms": device_ms, "kernels": launches, "top": top}


def _rel(a, ref):
    return float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def _token_ce(cfg, params, batch, plain):
    """Per-token cross entropy (float32) under no_grad."""
    from repro_torch.models import model as M

    with torch.no_grad():
        logits, _ = M.forward(cfg, params, batch["tokens"], plain_attention=plain)
        logits = logits.float()
        gold = logits.gather(-1, batch["labels"][..., None].long())[..., 0]
        return torch.logsumexp(logits, -1) - gold


def train_checks(dev, cfg):
    """One batch, one loss-and-gradient each, no remat, weights from seed
    0: the kernel path against plain attention in bf16 (beside the plain
    path's own spread over other KV chunks) and in float32 compute."""
    from repro_torch.data.loader import LoaderConfig, TokenBatchLoader
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import model as M
    from repro_torch.train.train_step import loss_and_grads, to_device
    from repro_torch.train.tree import flatten_with_path

    batch = to_device(next(TokenBatchLoader(LoaderConfig(**TRAIN_LOADER))), dev)
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    def run(c, plain):
        before = flash_attention.launches
        grads, metrics = loss_and_grads(c, params, batch, plain_attention=plain)
        n = flash_attention.launches - before
        if n != (0 if plain else c.n_layers):
            raise AssertionError(f"{n} flash launches in one {'plain' if plain else 'kernel'} step")
        return dict(flatten_with_path(grads)), float(metrics["loss"]), _token_ce(c, params, batch, plain)

    out = {}
    gk, lk, tk = run(cfg, False)
    gp, lp, tp = run(cfg, True)
    spread = {"loss": 0.0, "token_ce": 0.0, "grads": {key: 0.0 for key in gp}}
    for chunk in TRAIN_SPREAD_CHUNKS:
        gs, ls, ts = run(dataclasses.replace(cfg, attn_chunk=chunk), True)
        spread["loss"] = max(spread["loss"], abs(ls - lp))
        spread["token_ce"] = max(spread["token_ce"], float((ts - tp).abs().max()))
        for key in gp:
            spread["grads"][key] = max(spread["grads"][key], _rel(gs[key], gp[key]))
        del gs
    bf16 = {
        "loss": abs(lk - lp),
        "token_ce": float((tk - tp).abs().max()),
        "grads": {key: _rel(gk[key], gp[key]) for key in gp},
        "plain_spread": spread,
        "loss_kernels": lk,
        "loss_plain": lp,
    }
    out["bf16"] = bf16
    print(f"training bf16, kernels vs plain: {json.dumps(bf16)}")
    # the per-token losses, as phases 5 and 8 bound logits: the mean over
    # 8,192 tokens averages the rounding away, so its own spread is one
    # draw of noise (its deviation is at most the largest token's)
    if bf16["token_ce"] > 2 * spread["token_ce"]:
        raise AssertionError("bf16 per-token losses part from plain beyond twice its own spread")
    worst = max(bf16["grads"], key=bf16["grads"].get)
    if bf16["grads"][worst] > TRAIN_BF16_GRAD_TOL:
        raise AssertionError(f"bf16 gradient {worst} parts from plain by {bf16['grads'][worst]:.3e}")
    del gk, gp

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gk, lk, tk = run(cfg32, False)
    gp, lp, tp = run(cfg32, True)
    f32 = {
        "loss": abs(lk - lp),
        "token_ce": float((tk - tp).abs().max()),
        "grads": {key: _rel(gk[key], gp[key]) for key in gp},
    }
    out["float32"] = f32
    print(f"training float32, kernels vs plain: {json.dumps(f32)}")
    if f32["loss"] > F32_TOL or max(f32["grads"].values()) > F32_TOL:
        raise AssertionError(f"float32 loss or gradients part from plain beyond {F32_TOL}")
    del gk, gp, params
    free_card()
    return out


# -- phase 11 ----------------------------------------------------------------

#: phase 11: the distributed serving path, 4 ranks on the one card over gloo
#: (NCCL refuses two ranks on one GPU), built once by this process
DIST_RANKS = 4
DIST_REQUESTS = 8
DIST_CAPACITY = 2048
DIST_TICKS = 32
#: the reference's bound for the sharded decode (tests/test_perf_paths.py:151)
DIST_F32_TOL = 2e-3
#: a KV cache's entries indexed by slot, the part sharded on capacity
SLOTS = ("k", "v", "pos")
#: (b): one MoE layer at jamba-v0.1's widths, x of 8 x 256 tokens
DIST_MOE_ARCH = "jamba-v0.1-52b"
DIST_MOE_X = (8, 256)
DIST_MOE_Y_TOL = 2e-4  # of max |y|
DIST_MOE_AUX_TOL = 1e-5
#: (c): the collectives on one qwen3-0.6b block's gradients
DIST_COLL_TOL = 1e-5
DIST_INT8_TOL = 0.02


def _row_view(caches, i):
    """Row ``i`` of a batched cache tree, as views (writes go through)."""
    from repro_torch.models.transformer import tree_map

    return {
        "lead": [tree_map(lambda t: t[i : i + 1], c) for c in caches["lead"]],
        "scan": [tree_map(lambda t: t[:, i : i + 1], c) for c in caches["scan"]],
    }


def _tree_bytes(tree, names=None):
    """Bytes of a tree's tensors; with ``names``, of the dict entries so
    named only (a cache's "k", "v" and "pos": its slots)."""
    from repro_torch.convert import leaves

    if isinstance(tree, dict):
        return sum(_tree_bytes(v, names) for k, v in tree.items()  # det: ok a sum
                   if names is None or isinstance(v, (dict, list)) or k in names)
    if isinstance(tree, list):
        return sum(_tree_bytes(v, names) for v in tree)
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def dist_decode(cfg, params, trace, dev, forced=None):
    """Prefill each request of ``trace`` into its own row of a batched
    cache of DIST_CAPACITY slots (``M.prefill``), then DIST_TICKS ticks of
    ``M.decode_step`` over the batch, under whatever sharding rules are
    bound. Feeds ``forced`` tokens ((ticks + 1, B), the 1-rank run's)
    when given, else its greedy ones. Returns the first-token and per-tick
    logits (float32, on the card: ranks share tensors through CUDA IPC
    only), the tokens fed, each tick's ms (the card synchronised) and the
    cache tree."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    b = len(trace)
    caches = T.init_caches(cfg, b, DIST_CAPACITY, device=dev)
    first = []
    for i, (prompt, _, _) in enumerate(trace):
        toks = torch.as_tensor(prompt, device=dev)[None]
        lg, _ = M.prefill(cfg, params, toks, _row_view(caches, i))
        first.append(lg[0])
    logits = [torch.stack(first).float()]
    tok = forced[0] if forced is not None else logits[0].argmax(-1)
    pos = torch.tensor([len(p) for p, _, _ in trace], dtype=torch.int32, device=dev)
    fed, ms = [tok], []
    torch.cuda.synchronize()
    for t in range(DIST_TICKS):
        t0 = time.perf_counter()
        lg, _ = M.decode_step(cfg, params, tok, pos, caches)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg.float())
        tok = forced[t + 1] if forced is not None else lg.argmax(-1)
        fed.append(tok)
        pos = pos + 1
    return logits, torch.stack(fed), ms, caches


def _dist_cfgs():
    cfg = serve_cfg()
    return {"bf16": cfg, "float32": dataclasses.replace(cfg, dtype="float32")}


def _moe_cfgs():
    from repro_torch.configs import get_config

    cfg = get_config(DIST_MOE_ARCH)
    return {
        dt: dataclasses.replace(cfg, dtype=dt, param_dtype=dt) for dt in ("float32", "bfloat16")
    }


def _grad_elements(cfg):
    """One qwen3-0.6b block's matrix parameters: q, k, v, o and the MLP."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return 2 * d * hq * hd + 2 * d * hkv * hd + 3 * d * cfg.d_ff


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _host_ms(fn, reps=3):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return _median(times)


class _CollectiveClock:
    """Host seconds inside ``torch.distributed.all_reduce`` while entered
    (each call blocks its rank until the reduced tensor is back on the
    card): the merges' share of a decode tick."""

    def __enter__(self):
        self.seconds, self.calls = 0.0, 0
        self._orig = torch.distributed.all_reduce

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = self._orig(*args, **kwargs)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        torch.distributed.all_reduce = timed
        return self

    def __exit__(self, *exc):
        torch.distributed.all_reduce = self._orig


def phase11_rank(rank, world, job):
    """One rank of phase 11: (a) the capacity-sharded decode, (b) the
    shard-local MoE layer, (c) the collectives. Returns its numbers."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.compat import set_mesh
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import moe

    dev = torch.device("cuda", 0)
    out = {"rank": rank}
    mesh = DeviceMesh("cuda", torch.arange(world).reshape(1, world), mesh_dim_names=("data", "model"))

    # (a) qwen3-0.6b, cache_cap on "model": 512 of 2048 slots a rank
    cfgs = _dist_cfgs()
    rules = sh.strategy_for(cfgs["bf16"], mesh, decode_flash_shard=True)
    if rules.rules["cache_cap"] != "model":
        raise AssertionError(f"cache_cap rule {rules.rules['cache_cap']}")
    flash_attention.launches = decode_attention.launches = 0
    for name, p in (("bf16", job["cast"]), ("float32", job["params"])):
        base = job["base"][name]
        with sh.logical_axis_rules(rules), _CollectiveClock() as clock:
            logits, _, ms, caches = dist_decode(cfgs[name], p, job["trace"], dev, base["tokens"])
        err = torch.stack([(a - b).abs().max() for a, b in zip(logits, base["logits"], strict=True)])
        argmax = torch.stack([lg.argmax(-1) for lg in logits])
        finite = all(bool(torch.isfinite(lg).all()) for lg in logits)
        k = caches["scan"][0]["k"]
        out[name] = {"err": err.cpu().tolist(), "argmax": argmax.cpu().numpy(), "tick_ms": ms,
                     "finite": finite, "cache_bytes": _tree_bytes(caches, SLOTS), "k_shape": tuple(k.shape),
                     "merge_ms_per_tick": clock.seconds * 1e3 / DIST_TICKS,
                     "merges_per_tick": clock.calls / DIST_TICKS}
        del caches, logits
    out["launches"] = {"flash_attention": flash_attention.launches,
                       "decode_attention": decode_attention.launches}

    # (b) jamba-v0.1's MoE layer, EP over "model": 4 of 16 experts a rank
    mcfgs = _moe_cfgs()
    mrules = sh.strategy_for(mcfgs["float32"], mesh, moe_shard_map=True)
    if mrules.rules["expert"] != "model":
        raise AssertionError(f"expert rule {mrules.rules['expert']}")
    e_loc = mcfgs["float32"].n_experts // world
    local = {}
    for dt, whole in job.pop("moe").items():  # det: ok two dtypes, each handled alike
        local[dt] = {k: (v[rank * e_loc : (rank + 1) * e_loc] if k in ("wi", "wg", "wo") else v).clone()
                     for k, v in whole.items()}
    del whole  # the shared whole weights: the rank keeps its experts only
    x32 = job["moe_x"].clone()
    y_ref, aux_ref = job["moe_ref"]
    torch.cuda.synchronize()
    with sh.logical_axis_rules(mrules):
        y, aux = moe.apply_moe(mcfgs["float32"], local["float32"], x32)
        rel = float((y - y_ref).abs().max() / y_ref.abs().max())
        aux_err = {k: abs(float(aux[k]) - aux_ref[k]) for k in sorted(aux_ref)}
        x16 = x32.to(torch.bfloat16)
        moe_ms = _median_event_ms(lambda: moe.apply_moe(mcfgs["bfloat16"], local["bfloat16"], x16))
    out["moe"] = {
        "rel_err": rel, "aux_err": aux_err, "ms_bf16": moe_ms, "finite": bool(torch.isfinite(y).all()),
        "expert_bytes": {dt: sum(local[dt][k].numel() * local[dt][k].element_size()
                                 for k in ("wi", "wg", "wo")) for dt in local},
    }
    del local, y, x32, x16

    # (c) the collectives on one qwen3-0.6b block's gradients
    n = job["grad_elements"]
    g = torch.from_numpy(np.random.default_rng(rank).standard_normal(n, dtype=np.float32)).to(dev)
    pod_data = DeviceMesh("cuda", torch.arange(world).reshape(2, world // 2),
                          mesh_dim_names=("pod", "data"))
    data = DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("data",))

    def flat_sum():
        y = g.clone()
        torch.distributed.all_reduce(y)
        return y

    flat = flat_sum()
    with set_mesh(pod_data):
        hier = C.hierarchical_psum(g)
        hier_ms = _host_ms(lambda: C.hierarchical_psum(g))
    flat_ms = _host_ms(flat_sum)
    with set_mesh(data):
        red, resid = C.int8_allreduce(g, axis="data")
        mean = C.pmean(g, "data")
        int8_ms = _host_ms(lambda: C.int8_allreduce(g, axis="data"))
    out["coll"] = {
        "hier_rel": float((hier - flat).abs().max() / flat.abs().max()),
        "int8_rel": float((red - mean).abs().max() / mean.abs().max()),
        "resid_max": float(resid.abs().max()),
        "flat_ms": flat_ms, "hier_ms": hier_ms, "int8_ms": int8_ms,
    }
    job.clear()  # release the weights shared through CUDA IPC before exit
    return out


def phase11_nccl(rank, world, n):
    """The collectives once under a world-1 NCCL group on the card: they
    must return their input (int8: within its quantization)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.compat import set_mesh

    dev = torch.device("cuda", 0)
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(n, dtype=np.float32)).to(dev)
    with set_mesh(DeviceMesh("cuda", torch.zeros(1, 1, dtype=torch.int64), mesh_dim_names=("pod", "data"))):
        hier = C.hierarchical_psum(g)
        hier_ms = _host_ms(lambda: C.hierarchical_psum(g))
    with set_mesh(DeviceMesh("cuda", torch.zeros(1, dtype=torch.int64), mesh_dim_names=("data",))):
        red, resid = C.int8_allreduce(g, axis="data")
        int8_ms = _host_ms(lambda: C.int8_allreduce(g, axis="data"))
    return {
        "backend": torch.distributed.get_backend(),
        "hier_equal": bool(torch.equal(hier, g)),
        "int8_rel": float((red - g).abs().max() / g.abs().max()),
        "resid_max": float(resid.abs().max()),
        "hier_ms": hier_ms, "int8_ms": int8_ms,
    }


def _wire_bytes(n_bytes, world, pod):
    """Bytes a rank sends, by each algorithm's textbook schedule: a ring
    all-reduce, the hierarchical one (RS → AR → AG over pod × inner) and
    the int8 one (all-to-all then all-gather of int8 blocks and scales)."""
    inner = world // pod
    ring = 2 * n_bytes * (world - 1) / world
    hier = (2 * n_bytes * (inner - 1) / inner + 2 * (n_bytes / inner) * (pod - 1) / pod)
    seg = -(-(n_bytes // 4) // world)  # float32 elements a rank owns, in whole blocks
    seg = -(-seg // 256) * 256
    q = seg * world * (1 + 4 / 256)  # int8 blocks and one float32 scale per 256
    int8 = q * (world - 1) / world + (q / world) * (world - 1)
    return {"ring": ring, "hierarchical": hier, "hierarchical_outer": 2 * (n_bytes / inner) * (pod - 1) / pod,
            "int8": int8}


def run_distributed(dev, bf16_spread):
    """Phase 11: the distributed serving path, 4 ranks on the one card."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.spawn import run_ranks
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import model as M
    from repro_torch.models import moe

    card = card_line()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"sharding.HBM_BYTES {sh.HBM_BYTES:.0f} B; the card's total_memory {total} B  [{card}]")
    cfgs = _dist_cfgs()
    cfg = cfgs["bf16"]
    trace = serve_trace(cfg)[:DIST_REQUESTS]
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    cast = M.cast_params(cfg, params)

    # the 1-rank run, no rules: prefill on the flash kernel, decode on the
    # decode kernel; its greedy tokens are fed to the sharded run
    flash_attention.launches = decode_attention.launches = 0
    base, base_ms, whole_bytes = {}, {}, {}
    for name, p in (("bf16", cast), ("float32", params)):
        logits, fed, ms, caches = dist_decode(cfgs[name], p, trace, dev)
        base[name] = {"logits": logits, "tokens": fed}
        base_ms[name] = ms
        whole_bytes[name] = _tree_bytes(caches, SLOTS)
        del caches
    base_launches = {"flash_attention": flash_attention.launches,
                     "decode_attention": decode_attention.launches}

    # (b)'s weights from seed 0 (all 16 experts), x and the spmd reference
    mcfgs = _moe_cfgs()
    mp = moe.init_moe(mcfgs["float32"], torch.Generator(device=dev).manual_seed(0), dev)
    mp16 = {k: v.to(torch.bfloat16) for k, v in mp.items()}
    x = randn(DIST_MOE_X + (mcfgs["float32"].d_model,), 1, dev)
    y_ref, aux_ref = moe.apply_moe_spmd(mcfgs["float32"], mp, x)
    x16 = x.to(torch.bfloat16)
    spmd_ms = _median_event_ms(lambda: moe.apply_moe_spmd(mcfgs["bfloat16"], mp16, x16))
    expert_whole = {dt: sum(w[k].numel() * w[k].element_size() for k in ("wi", "wg", "wo"))
                    for dt, w in (("float32", mp), ("bfloat16", mp16))}

    n_grad = _grad_elements(cfg)
    job = {"trace": trace, "params": params, "cast": cast, "base": base,
           "moe": {"float32": mp, "bfloat16": mp16}, "moe_x": x,
           "moe_ref": (y_ref, {k: float(v) for k, v in aux_ref.items()}),
           "grad_elements": n_grad}
    t0 = time.perf_counter()
    ranks = run_ranks(phase11_rank, DIST_RANKS, (job,), backend="gloo", device=0,
                      threads=2, timeout=900)
    spawn_s = time.perf_counter() - t0
    nccl = run_ranks(phase11_nccl, 1, (n_grad,), backend="nccl", device=0, timeout=300)[0]
    del job, mp, mp16, params, cast

    stats = {"card": card, "ranks": DIST_RANKS, "backend": "gloo", "ranks_s": spawn_s}
    # (a)
    b, hq, d = len(trace), cfg.n_heads, cfg.head_dim
    merge = b * hq * (d + 2) * 4
    a = {"merge_bytes_per_layer_each_way": merge, "staged_bytes": 0, "staged_ops": []}
    for name in ("bf16", "float32"):
        tol = DIST_F32_TOL if name == "float32" else 2 * bf16_spread
        err = max(max(r[name]["err"]) for r in ranks)
        gaps = [_top2_gap(lg) for lg in base[name]["logits"]]
        near = next((t for t, gp in enumerate(gaps) if bool((gp <= tol).any())), len(gaps))
        fed = base[name]["tokens"].cpu().numpy()
        agree = next((t for t in range(len(gaps))
                      if any(not np.array_equal(r[name]["argmax"][t], fed[t]) for r in ranks)),
                     len(gaps))
        cache = [r[name]["cache_bytes"] for r in ranks]
        a[name] = {
            "max_abs_logit_err": err, "bound": tol, "first_near_tie": near,
            "tokens_agree_up_to": agree,
            "tick_ms_4_ranks": max(_median(r[name]["tick_ms"][1:]) for r in ranks),
            "tick_ms_1_rank": _median(base_ms[name][1:]),
            "cache_bytes_per_rank": cache, "cache_bytes_whole": whole_bytes[name],
            "local_k_shape": ranks[0][name]["k_shape"],
            "merge_ms_per_tick": max(r[name]["merge_ms_per_tick"] for r in ranks),
            "merges_per_tick": ranks[0][name]["merges_per_tick"],
        }
        print(f"phase 11a {name}: {json.dumps(a[name])}  [{card}]")
        if not all(r[name]["finite"] for r in ranks):
            raise AssertionError(f"11a {name}: logits not finite")
        if err > tol:
            raise AssertionError(f"11a {name}: sharded decode logits part by {err} > {tol}")
        if agree < near:
            raise AssertionError(f"11a {name}: greedy tokens part at {agree} before a near tie at {near}")
        if any(4 * c != whole_bytes[name] for c in cache):
            raise AssertionError(f"11a {name}: rank caches {cache} are not 1/4 of {whole_bytes[name]}")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in base_launches}
    want = cfg.n_layers * DIST_REQUESTS * 2 * DIST_RANKS
    if launches["flash_attention"] != want or launches["decode_attention"]:
        raise AssertionError(f"11a: ranks' launches {launches}, want {want} flash and no decode")
    a["launches_ranks"], a["launches_1_rank"] = launches, base_launches
    print(f"phase 11a: merge {merge} B a layer each way (B*Hq*(D+2)*4), staged through the host "
          f"by the port: 0 B (no op staged: gloo took every collective on CUDA tensors); "
          f"flash launches: ranks {launches['flash_attention']}, 1-rank run "
          f"{base_launches['flash_attention']}  [{card}]")
    # (b)
    mo = {"rel_err": max(r["moe"]["rel_err"] for r in ranks),
          "aux_err": {k: max(r["moe"]["aux_err"][k] for r in ranks) for k in aux_ref},
          "ms_bf16_ep4": max(r["moe"]["ms_bf16"] for r in ranks), "ms_bf16_spmd_1_rank": spmd_ms,
          "expert_bytes_per_rank": [r["moe"]["expert_bytes"] for r in ranks],
          "expert_bytes_whole": expert_whole}
    print(f"phase 11b: {json.dumps(mo)}  [{card}]")
    if mo["rel_err"] > DIST_MOE_Y_TOL or max(mo["aux_err"].values()) > DIST_MOE_AUX_TOL:
        raise AssertionError(f"11b: EP-4 MoE parts from spmd: {mo}")
    if not all(r["moe"]["finite"] for r in ranks):
        raise AssertionError("11b: MoE output not finite")
    for r in ranks:
        for dt, nb in r["moe"]["expert_bytes"].items():
            if 4 * nb != expert_whole[dt]:
                raise AssertionError(f"11b: rank {r['rank']} holds {nb} B of {dt} experts")
    # (c)
    co = {"elements": n_grad, "gloo": {k: max(r["coll"][k] for r in ranks) for k in ranks[0]["coll"]},
          "nccl_world_1": nccl, "wire_bytes_per_rank": _wire_bytes(4 * n_grad, DIST_RANKS, 2)}
    print(f"phase 11c: {json.dumps(co)}  [{card}]")
    if co["gloo"]["hier_rel"] > DIST_COLL_TOL:
        raise AssertionError(f"11c: hierarchical_psum parts from all_reduce by {co['gloo']['hier_rel']}")
    if co["gloo"]["int8_rel"] > DIST_INT8_TOL or min(r["coll"]["resid_max"] for r in ranks) <= 0:
        raise AssertionError(f"11c: int8_allreduce {co['gloo']}")
    if nccl["backend"] != "nccl" or not nccl["hier_equal"] or nccl["int8_rel"] > DIST_INT8_TOL:
        raise AssertionError(f"11c: world-1 NCCL run {nccl}")
    stats.update(decode=a, moe=mo, collectives=co)
    total_launches = {k: launches[k] + base_launches[k] for k in launches}
    free_card()
    return total_launches, stats



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
    del params
    print(f"gateway phase: {time.perf_counter() - t0:.3f} s")
    free_card()

    blocks = {}
    for n, arch in enumerate(BLOCK_MODELS, start=8):
        phase(f"{n}. {arch} path")
        t0 = time.perf_counter()
        blocks[arch] = run_block_model(dev, arch)
        print(f"{arch} phase: {time.perf_counter() - t0:.3f} s")

    phase("10. training path")
    t0 = time.perf_counter()
    tcfg = train_cfg()
    err["flash_attention"] = max(err["flash_attention"], check_train_flash(dev, tcfg))
    train_launches, train_stats = run_training(dev, tcfg)
    train_err = train_checks(dev, tcfg)
    train_stats["attention"] = time_train_attention(dev, tcfg)
    print(f"training phase: {time.perf_counter() - t0:.3f} s")

    phase("11. distributed serving path (4 ranks on the card)")
    t0 = time.perf_counter()
    dist_launches, dist_stats = run_distributed(dev, serve_err["bf16_plain_spread"])
    print(f"distributed phase: {time.perf_counter() - t0:.3f} s")

    # the attention kernels' launches: every serving phase's path and training's
    for name in ("flash_attention", "decode_attention"):
        launches[name] = serve_launches[name] + gateway_launches[name]
        launches[name] += sum(b[0][name] for b in blocks.values())
        launches[name] += train_launches.get(name, 0)
        launches[name] += dist_launches[name]
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
    print(f"gateway launches (phase 7): {json.dumps(gateway_launches)}")
    for arch, (block_launches, block_stats, block_err) in blocks.items():
        print(f"{arch}: {json.dumps(block_stats)}")
        print(f"{arch}, max |prefill logits, kernels - plain|: {json.dumps(block_err)}")
        print(f"{arch} launches: {json.dumps(block_launches)}")
    print(f"training: {json.dumps(train_stats)}")
    print(f"training, kernels vs plain: {json.dumps(train_err)}")
    print(f"training launches (phase 10): {json.dumps(train_launches)}")
    print(f"distributed: {json.dumps(dist_stats)}")
    print(f"distributed launches (phase 11): {json.dumps(dist_launches)}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    count = torch.cuda.device_count()
    device = {"platform": "gpu", "kind": kind, "count": count}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
