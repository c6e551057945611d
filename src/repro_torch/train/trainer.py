"""Training loop wired into the JITA-4DS machinery.

A port of ``repro.train.trainer``, with the same events, checkpoint
cadence, restarts and history records:

  * the **host data pipeline** (repro_torch.data.loader) is the "edge":
    it runs on the host CPU and overlaps device steps via the Prefetcher;
  * the **device step** (repro_torch.train.train_step) runs on the card
    unless the caller passes another ``device``;
  * **checkpoints** commit atomically every ``ckpt_every`` steps;
  * **failure injection / straggler conviction** drive the elastic paths:
    restart from the latest checkpoint onto a shrunk data axis, straggler
    exclusion, rejoin-grow (repro_torch.train.fault_tolerance).

"Workers" are simulated, as in the reference on one host; a step's time
is read after the card has finished it.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.convert import resolve_device, synchronize
from repro_torch.models.config import ModelConfig
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import FailureInjector, RecoveryPolicy
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import build_train_step, init_train_state, to_device


@dataclasses.dataclass
class TrainerConfig:
    n_steps: int = 50
    ckpt_every: int = 10
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    grad_accum: int = 1
    remat: bool = False
    seed: int = 0
    n_workers: int = 4              # simulated hosts for FT bookkeeping
    devices_per_worker: int = 1
    model_axis: int = 1


class Trainer:
    def __init__(self, cfg: ModelConfig, opt_cfg: OptConfig,
                 tcfg: TrainerConfig,
                 data: Iterator[Dict[str, np.ndarray]],
                 injector: Optional[FailureInjector] = None,
                 device: Optional[object] = None) -> None:
        """``device`` defaults to the card (raises without one); weights
        come from ``tcfg.seed`` through a generator on that device."""
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.data = data
        self.device = resolve_device(device)
        self.injector = injector or FailureInjector([])
        workers = [f"w{i}" for i in range(tcfg.n_workers)]
        self.recovery = RecoveryPolicy(workers, tcfg.devices_per_worker,
                                       tcfg.model_axis)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        self.step_fn = build_train_step(
            cfg, opt_cfg, remat=tcfg.remat, grad_accum=tcfg.grad_accum)
        gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        self.state = init_train_state(cfg, opt_cfg, gen, self.device)
        self.history: List[Dict[str, float]] = []
        self.data_axis = tcfg.n_workers * tcfg.devices_per_worker
        self.restarts = 0

    # -- fault-tolerance hooks ------------------------------------------------------
    def _handle_events(self, step: int) -> None:
        for ev in self.injector.at(step):
            act = self.recovery.handle(step, ev, self.data_axis)
            if act.action == "restart_from_checkpoint":
                latest = self.ckpt.latest_step()
                if latest is not None:
                    self.state = self.ckpt.restore(self.state, step=latest)
                    act.restored_step = latest
                self.data_axis = act.plan.mesh_shape["data"]
                self.restarts += 1
            elif act.action == "remesh_grow":
                self.data_axis = act.plan.mesh_shape["data"]

    # -- main loop --------------------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        t_start = time.perf_counter()
        step = int(self.state["step"])
        while step < self.tcfg.n_steps:
            self._handle_events(step)
            batch = to_device(next(self.data), self.device)
            synchronize(batch)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            synchronize(metrics["loss"])
            dt = time.perf_counter() - t0
            step = int(self.state["step"])

            # feed simulated per-worker step times to the straggler monitor
            times = {w: dt for w in self.recovery.healthy_workers}
            self.recovery.check_stragglers(step, times, now=time.perf_counter(),
                                           current_data_axis=self.data_axis)

            rec = {"step": step, "loss": float(metrics["loss"]),
                   "ce": float(metrics["ce"]), "lr": float(metrics["lr"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "step_time_s": dt}
            self.history.append(rec)
            if step % self.tcfg.log_every == 0:
                print(f"step {step:>6}  loss {rec['loss']:.4f}  "
                      f"ce {rec['ce']:.4f}  gnorm {rec['grad_norm']:.2f}  "
                      f"{dt*1e3:.0f} ms")
            if step % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step, self.state)
        self.ckpt.save(step, self.state)
        return {"history": self.history,
                "wall_s": time.perf_counter() - t_start,
                "restarts": self.restarts,
                "recovery_log": self.recovery.log.actions}
