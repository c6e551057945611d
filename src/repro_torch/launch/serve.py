"""Serving launcher: continuous batching + JITA request scheduling.

    python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 16
    python -m repro_torch.launch.serve --smoke --cpu      # without a card

Serves a synthetic request trace under each admission policy (fcfs, the
paper's EFT rule, edf) and prints latency stats from the engine's
abstract clock, with the wall time of each run. The full config on the
card is the default; ``--smoke`` takes the arch's reduced config and
``--cpu`` the CPU (the attention kernels' plain versions). Weights are
random, from seed 0; a VLM arch gets the frontend stub's patch
embeddings, as in the reference launcher.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.vos import ValueCurve
from repro_torch.models import frontends
from repro_torch.models import model as model_lib
from repro_torch.serve.engine import EngineConfig, RequestSpec, ServeEngine


def synth_requests(cfg, n: int, seed: int = 0):
    """The reference launcher's trace: prompts of 4–23 tokens, 4–15 new
    tokens, arrivals every 0.25, step deadlines 50–400 after arrival."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(4, 24))
        out.append(
            RequestSpec(
                rid=i,
                prompt=rng.integers(2, cfg.vocab_size, size=plen).astype(np.int32),
                max_new_tokens=int(rng.integers(4, 16)),
                arrival=float(i) * 0.25,
                curve=ValueCurve.step(float(i) * 0.25 + float(rng.uniform(50, 400))),
            )
        )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced config")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--policy", default="all", choices=("fcfs", "eft", "edf", "all"))
    args = ap.parse_args(argv)

    device = convert.resolve_device("cpu" if args.cpu else None)
    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model_lib.init(cfg, gen, device)
    vision = frontends.fake_patch_embeddings(cfg, 1)[0] if cfg.family == "vlm" else None
    policies = ("fcfs", "eft", "edf") if args.policy == "all" else (args.policy,)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{cfg.name} on {name}")
    for policy in policies:
        ecfg = EngineConfig(max_batch=args.max_batch, max_seq=args.max_seq, policy=policy)
        eng = ServeEngine(cfg, params, ecfg, vision=vision)
        for r in synth_requests(cfg, args.requests):
            eng.submit(r)
        t0 = time.perf_counter()
        done = eng.run()
        wall = time.perf_counter() - t0
        st = eng.latency_stats()
        print(
            f"{policy:<5} finished={len(done):>3}  "
            f"mean_latency={st['mean_latency']:8.1f}  "
            f"p95={st['p95_latency']:8.1f}  mean_wait={st['mean_wait']:7.1f}  "
            f"wall={wall:.3f}s"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
