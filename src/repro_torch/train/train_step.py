"""Train-step builder: loss/grad + mixed precision + remat + grad-accum.

A port of ``repro.train.train_step``. ``build_train_step`` returns a
``(state, batch) → (state, metrics)`` function. The loss is computed from
the float32 masters themselves: every product casts its weight to the
activation type (``w.to(x.dtype)``), as the JAX layers do, so the
gradient reaches the masters in float32. Gradient accumulation sums the
microbatches' float32 gradients and divides by their count, as the
reference's scan does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import OptConfig, apply_updates, init_opt_state
from repro_torch.train.tree import leaves, tree_map, unflatten

TrainState = Dict[str, Any]  # {"params", "opt", "step"}


def init_train_state(
    cfg: ModelConfig, opt_cfg: OptConfig, generator: torch.Generator, device
) -> TrainState:
    """Parameters from ``model.init`` (``generator`` lives on ``device``'s
    type), a fresh optimizer state and step 0."""
    params = model_lib.init(cfg, generator, device)
    return {
        "params": params,
        "opt": init_opt_state(params, opt_cfg),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in sorted(batch.items())}


def loss_and_grads(
    cfg: ModelConfig, params, batch, **loss_kw
) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """(float32 gradient tree of ``params``' shape, detached metrics) of
    ``model.loss_fn``; a leaf the loss does not reach gets zeros."""
    flat = [t.detach().requires_grad_() for t in leaves(params)]
    live = unflatten(params, flat)
    loss, metrics = model_lib.loss_fn(cfg, live, batch, **loss_kw)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads, strict=True)]
    return unflatten(params, grads), {k: v.detach() for k, v in sorted(metrics.items())}


def build_train_step(
    cfg: ModelConfig,
    opt_cfg: OptConfig,
    *,
    remat: bool = True,
    grad_accum: int = 1,
    loss_chunk: int = 0,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    loss_kw = dict(remat=remat, loss_chunk=loss_chunk)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        params = state["params"]
        batch = to_device(batch, state["step"].device)
        if grad_accum > 1:
            micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])
                     for k, v in sorted(batch.items())}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            ms = []
            for i in range(grad_accum):
                g, m = loss_and_grads(cfg, params, {k: v[i] for k, v in sorted(micro.items())}, **loss_kw)
                grads = tree_map(lambda a, b_: a + b_.to(torch.float32), grads, g)
                ms.append(m)
            grads = tree_map(lambda g: g / grad_accum, grads)
            metrics = {k: torch.stack([m[k] for m in ms]).mean(0) for k in ms[0]}
        else:
            grads, metrics = loss_and_grads(cfg, params, batch, **loss_kw)

        with torch.no_grad():
            new_params, new_opt, opt_stats = apply_updates(params, grads, state["opt"], opt_cfg)
        metrics = dict(metrics, **opt_stats)
        return {"params": new_params, "opt": new_opt, "step": state["step"] + 1}, metrics

    return train_step


# ---------------------------------------------------------------------------
# Eval step (perplexity over a batch; used by trainer + examples)
# ---------------------------------------------------------------------------


def build_eval_step(cfg: ModelConfig):
    def eval_step(params, batch):
        batch = to_device(batch, leaves(params)[0].device)
        with torch.no_grad():
            _, metrics = model_lib.loss_fn(cfg, params, batch, remat=False)
        return metrics

    return eval_step
