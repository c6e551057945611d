"""Serving example of the port: engine policies + the SLO-aware gateway.

The counterpart of ``examples/serve_lm.py``. Part 1 submits a bursty trace
to the continuous-batching engine under three admission policies and
compares latency on the engine's abstract clock: the paper's scheduling
claim (EFT beats naive ordering) shows up at the request level too. Part 2
plans the same trace through the :class:`ServingGateway` (per-tier value
curves on the online driver, on the host) and replays the plan into the
engine, whose prefills and decode ticks run through the attention
kernels.

    PYTHONPATH=src python -m repro_torch.serve_lm                # on the card
    PYTHONPATH=src python -m repro_torch.serve_lm --cpu --smoke  # without one

qwen3-0.6b at its full config on the card is the default; ``--smoke``
takes its reduced config and ``--cpu`` the CPU (the kernels' plain
versions). Without a card and without ``--cpu`` it raises. Weights are
random, from seed 0.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.convert import resolve_device
from repro_torch.core.vos import tier_curve
from repro_torch.models import model as M
from repro_torch.serve import (
    EngineConfig,
    GatewayConfig,
    RequestSpec,
    ServeEngine,
    ServingGateway,
)


def trace(cfg, n=20, seed=0, absolute_curves=False):
    """Bimodal bursty trace: many short interactive chats + a few long
    batch generations. With ``absolute_curves`` each request carries its
    tier curve shifted to its arrival (engine-policy form: ``edf`` reads
    absolute hard deadlines); without, ``curve=None`` and the gateway
    applies the tier's canonical curve itself."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        long = rng.random() < 0.25
        tier = "batch" if long else "interactive"
        arrival = float(i // 4) * 2.0  # bursts of 4
        curve = tier_curve(tier, 40.0).shifted(arrival) if absolute_curves else None
        reqs.append(
            RequestSpec(
                rid=i,
                prompt=rng.integers(2, cfg.vocab_size, size=int(rng.integers(4, 16))).astype(
                    np.int32
                ),
                max_new_tokens=int(rng.integers(24, 48)) if long else int(rng.integers(2, 8)),
                arrival=arrival,
                tier=tier,
                curve=curve,
            )
        )
    return reqs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="qwen3-0.6b's reduced config")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    cfg = get_config("qwen3-0.6b", smoke=args.smoke)
    params = M.init(cfg, torch.Generator(device=device).manual_seed(0), device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"serving {cfg.name} on {name}: vocab {cfg.vocab_size}, {cfg.n_layers}L×{cfg.d_model}")
    results = {}
    for policy in ("fcfs", "eft", "edf"):
        eng = ServeEngine(cfg, params, EngineConfig(max_batch=4, max_seq=96, policy=policy))
        for r in trace(cfg, absolute_curves=True):
            eng.submit(r)
        t0 = time.perf_counter()
        done = eng.run()
        wall = time.perf_counter() - t0
        st = eng.latency_stats()
        results[policy] = st
        print(
            f"{policy:<5} finished {len(done):>3}  "
            f"mean latency {st['mean_latency']:7.1f}  "
            f"p95 {st['p95_latency']:7.1f}  wait {st['mean_wait']:6.1f}  "
            f"wall {wall:.3f}s"
        )
    if results["eft"]["mean_latency"] > results["fcfs"]["mean_latency"] * 1.05:
        raise AssertionError("EFT's mean latency is above FCFS's")
    print("serve_lm OK (EFT ≤ FCFS mean latency)")

    # part 2: SLO-aware plan (tier curves, vos admission) -> engine replay
    ecfg = EngineConfig(max_batch=4, max_seq=96, policy="fcfs")
    gw = ServingGateway(GatewayConfig(ecfg=ecfg, slo_unit=40.0, window_s=10.0))
    for r in trace(cfg):
        gw.offer(r)
    gw.drain()
    rep = gw.report()
    for tier in ("interactive", "batch"):
        row = rep.per_tier[tier]
        print(
            f"gateway {tier:<12} submitted {row['submitted']:>3}  "
            f"attainment {row['attainment']:.2f}"
        )
    t0 = time.perf_counter()
    st = gw.serve(ServeEngine(cfg, params, ecfg))
    wall = time.perf_counter() - t0
    if st["n"] != rep.n_completed:
        raise AssertionError(f"the engine finished {st['n']}, the plan kept {rep.n_completed}")
    print(
        f"gateway plan replayed on engine: {st['n']} requests, "
        f"goodput {rep.goodput:.2f}, wall {wall:.3f}s"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
