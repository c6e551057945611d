"""End-to-end training example of the port: the counterpart of
``examples/train_lm.py``. Trains a ~100M-class model for a few hundred
steps with checkpointing and an injected mid-run worker failure: the loop
recovers from the last committed checkpoint, shrinks the (simulated)
data axis, and finishes.

    PYTHONPATH=src python -m repro_torch.train_lm                 # on the card
    PYTHONPATH=src python -m repro_torch.train_lm --cpu --steps 40 --d-model 128 --layers 2

The defaults build a ≈100M-parameter model (8 layers × d_model 768, a
32k hash vocab, float32). ``--cpu`` trains on the CPU; without it the
card is taken, and the run raises when there is none.
"""

import argparse
import tempfile

from repro_torch.data.loader import LoaderConfig, Prefetcher, TokenBatchLoader
from repro_torch.models.config import ModelConfig
from repro_torch.train.fault_tolerance import FailureEvent, FailureInjector
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--fail-at", type=int, default=150)
    ap.add_argument("--cpu", action="store_true", help="train on the CPU")
    args = ap.parse_args(argv)

    cfg = ModelConfig(name="lm100m", n_layers=args.layers,
                      d_model=args.d_model, n_heads=args.d_model // 64,
                      n_kv_heads=max(args.d_model // 128, 1),
                      d_ff=args.d_model * 4, vocab_size=32768,
                      dtype="float32")
    n = cfg.param_counts()["total"]
    print(f"model: {n/1e6:.0f}M params, {cfg.n_layers}L×{cfg.d_model}")

    def stream():
        epoch = 0
        while True:
            for b in TokenBatchLoader(LoaderConfig(
                    batch_size=args.batch_size, seq_len=args.seq_len,
                    vocab_size=cfg.vocab_size, n_docs=512, seed=epoch)):
                yield b
            epoch += 1

    injector = FailureInjector(
        [FailureEvent(step=args.fail_at, worker="w2", kind="die")]
        if args.fail_at else [])
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(
            cfg,
            OptConfig(lr=3e-4, warmup_steps=args.steps // 10,
                      total_steps=args.steps),
            TrainerConfig(n_steps=args.steps, ckpt_every=50,
                          ckpt_dir=ckpt_dir, log_every=25, n_workers=4),
            Prefetcher(stream()), injector=injector,
            device="cpu" if args.cpu else None)
        out = trainer.train()
    h = out["history"]
    print(f"\nloss {h[0]['loss']:.3f} → {h[-1]['loss']:.3f} "
          f"({args.steps} steps, {out['wall_s']:.0f}s, "
          f"{out['restarts']} restart(s))")
    for a in out["recovery_log"]:
        print(f"  recovery: step {a.step} {a.event.kind}@{a.event.worker} "
              f"→ {a.action} (restored step {a.restored_step}, "
              f"mesh {a.plan.mesh_shape if a.plan else '-'})")
    if not h[-1]["loss"] < h[0]["loss"]:
        raise SystemExit("train_lm: the loss did not fall")
    print("train_lm OK")


if __name__ == "__main__":
    main()
