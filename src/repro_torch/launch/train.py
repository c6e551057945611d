"""End-to-end training driver of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --cpu --smoke --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --no-smoke --remat   # on the card

The counterpart of ``repro.launch.train``, with the same flags, plus
``--cpu``. The arch's reduced config is the default (``--smoke``);
``--no-smoke`` takes the full one. The card is the default device, and
without one the driver raises; ``--cpu`` runs on the CPU, where prompt
attention takes the flash kernel's plain version. The host data pipeline,
checkpointing, failure handling and straggler monitoring are the same
code paths on either device. Exits 0 only when the last loss is below
the first.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from repro_torch.configs import ARCHS, get_config
from repro_torch.data.loader import LoaderConfig, Prefetcher, TokenBatchLoader
from repro_torch.models import frontends
from repro_torch.train.fault_tolerance import FailureEvent, FailureInjector
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def data_stream(cfg, batch_size: int, seq_len: int, seed: int = 0):
    epoch = 0
    while True:
        loader = TokenBatchLoader(LoaderConfig(
            batch_size=batch_size, seq_len=seq_len,
            vocab_size=cfg.vocab_size, n_docs=256, seed=seed + epoch))
        for batch in loader:
            if cfg.family == "vlm":
                batch = dict(batch, vision=frontends.fake_patch_embeddings(
                    cfg, batch_size, seed=seed))
            yield batch
        epoch += 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (CPU-sized); --no-smoke for full")
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "adamw8bit", "adafactor", "sgdm"))
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, default=0,
                    help="simulate a worker death at this step (0 = off)")
    ap.add_argument("--cpu", action="store_true", help="train on the CPU")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    opt = OptConfig(name=args.optimizer, lr=args.lr,
                    warmup_steps=max(args.steps // 20, 1),
                    total_steps=args.steps)
    injector = None
    if args.inject_failure_at:
        injector = FailureInjector([FailureEvent(
            step=args.inject_failure_at, worker="w1", kind="die")])
    trainer = Trainer(
        cfg, opt,
        TrainerConfig(n_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, log_every=10,
                      grad_accum=args.grad_accum, remat=args.remat),
        Prefetcher(data_stream(cfg, args.batch_size, args.seq_len)),
        injector=injector, device="cpu" if args.cpu else None)
    out = trainer.train()
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    print(f"\ndone: loss {first:.4f} → {last:.4f} over {args.steps} steps, "
          f"{out['wall_s']:.1f}s wall, {out['restarts']} restart(s)")
    return 0 if last < first else 1


if __name__ == "__main__":
    sys.exit(main())
