"""Optimizers: AdamW, SGD-momentum, Adafactor-lite, 8-bit Adam states.

A port of ``repro.train.optimizer``: functional updates over parameter
trees (nested dicts and lists of tensors) with state trees of the
reference's shape, so a state carried across from the JAX package
(``repro_torch.convert.train_state_from_reference``) is a leaf-for-leaf
copy:

  * ``adamw`` — ``{"m", "v", "step"}``, float32 moments;
  * ``adamw8bit`` — moments stored int8 with per-block (256) absmax
    scales, ``{"q", "s"}`` per leaf;
  * ``adafactor`` — ``{"fac", "step"}``: factored second moment
    ``{"vr", "vc"}`` for ≥2-D leaves, full ``{"v"}`` for vectors;
  * ``sgdm`` — ``{"m", "step"}``.

Every update clips by the global norm and follows the warmup-cosine
schedule. The arithmetic is the reference's, op for op, in float32.
Call :func:`apply_updates` under ``torch.no_grad()`` (the train step
does).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.train.tree import leaves, tree_map

Params = Any

_QBLOCK = 256


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | adamw8bit | adafactor | sgdm
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    momentum: float = 0.9          # sgdm


@functools.lru_cache(maxsize=None)
def _cosf():
    """The C library's float32 cosine, which XLA's CPU backend calls: a
    float64 cosine rounded (or torch's float32 kernel) parts from it by an
    ulp on about 1 % of arguments."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.cosf.argtypes, libm.cosf.restype = [ctypes.c_float], ctypes.c_float
    return libm.cosf


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_frac·lr: a float32 scalar on
    ``step``'s device, computed on the host op for op in float32 as the
    reference computes it, so it is the reference's value bit for bit."""
    f32 = np.float32
    step_t = torch.as_tensor(step)
    s = f32(step_t.item())
    warm = min(s / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    prog = (s - f32(cfg.warmup_steps)) / f32(max(cfg.total_steps - cfg.warmup_steps, 1))
    prog = min(max(prog, f32(0.0)), f32(1.0))
    cos = f32(0.5) * (f32(1) + f32(_cosf()(f32(math.pi) * prog)))
    frac = f32(cfg.min_lr_frac) + f32(1 - cfg.min_lr_frac) * cos
    lr = f32(cfg.lr) * warm * frac
    return torch.tensor(lr, dtype=torch.float32, device=step_t.device)


# ---------------------------------------------------------------------------
# int8 block quantization (for adamw8bit)
# ---------------------------------------------------------------------------


def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize f32 → (int8 values (nb, 256), f32 per-block scales (nb, 1));
    ties round half to even, as ``jnp.round``."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    nb = -(-n // _QBLOCK)
    padded = torch.nn.functional.pad(flat, (0, nb * _QBLOCK - n)).reshape(nb, _QBLOCK)
    scale = padded.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(padded / scale.clamp_min(1e-12)).to(torch.int8)
    return q, scale


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _step0(params: Params) -> torch.Tensor:
    first = leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=first.device)


def init_opt_state(params: Params, cfg: OptConfig) -> Dict[str, Any]:
    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    if cfg.name == "adamw":
        return {"m": tree_map(f32, params), "v": tree_map(f32, params), "step": _step0(params)}
    if cfg.name == "adamw8bit":

        def q0(p):
            q, s = _q8(f32(p))
            return {"q": q, "s": s}

        return {"m": tree_map(q0, params), "v": tree_map(q0, params), "step": _step0(params)}
    if cfg.name == "adafactor":

        def fac(p):
            if p.dim() >= 2:
                return {
                    "vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "vc": torch.zeros(
                        p.shape[:-2] + p.shape[-1:], dtype=torch.float32, device=p.device
                    ),
                }
            return {"v": f32(p)}

        return {"fac": tree_map(fac, params), "step": _step0(params)}
    if cfg.name == "sgdm":
        return {"m": tree_map(f32, params), "step": _step0(params)}
    raise ValueError(f"unknown optimizer {cfg.name!r}")


# ---------------------------------------------------------------------------
# update
# ---------------------------------------------------------------------------


def global_norm(tree: Params) -> torch.Tensor:
    """√Σ g² over the leaves, summed in the reference's leaf order."""
    total = sum(torch.sum(leaf.to(torch.float32) ** 2) for leaf in leaves(tree))
    return torch.sqrt(total)


def clip_by_global_norm(grads: Params, max_norm: float) -> Tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / norm.clamp_min(1e-12), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


def _split(params: Params, outs: Params, n: int):
    """Per-leaf tuples of ``n`` results → ``n`` trees of ``params``' shape."""
    return tuple(tree_map(lambda _, o, i=i: o[i], params, outs) for i in range(n))


def apply_updates(
    params: Params, grads: Params, state: Dict[str, Any], cfg: OptConfig
) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One update → (new params, new state, {"lr", "grad_norm"}); the
    inputs are not modified."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)

    def tf32(t):
        return t.to(torch.float32)

    if cfg.name in ("adamw", "adamw8bit"):
        bc1 = 1 - cfg.b1 ** step.to(torch.float32)
        bc2 = 1 - cfg.b2 ** step.to(torch.float32)

        def upd(p, g, m, v):
            g = tf32(g)
            m_new = cfg.b1 * m + (1 - cfg.b1) * g
            v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
            mh = m_new / bc1
            vh = v_new / bc2
            delta = mh / (torch.sqrt(vh) + cfg.eps)
            if p.dim() >= 1 and cfg.weight_decay > 0:
                delta = delta + cfg.weight_decay * tf32(p)
            return (tf32(p) - lr * delta).to(p.dtype), m_new, v_new

        if cfg.name == "adamw":
            outs = tree_map(upd, params, grads, state["m"], state["v"])
            new_p, new_m, new_v = _split(params, outs, 3)
        else:  # adamw8bit: dequant → update → requant

            def upd8(p, g, mq, vq):
                m = _dq8(mq["q"], mq["s"], p.shape)
                v = _dq8(vq["q"], vq["s"], p.shape)
                p2, m2, v2 = upd(p, g, m, v)
                q_m, s_m = _q8(m2)
                q_v, s_v = _q8(v2)
                return p2, {"q": q_m, "s": s_m}, {"q": q_v, "s": s_v}

            outs = tree_map(upd8, params, grads, state["m"], state["v"])
            new_p, new_m, new_v = _split(params, outs, 3)
        new_state = {"m": new_m, "v": new_v, "step": step}

    elif cfg.name == "adafactor":
        d2 = 1 - cfg.b2 ** step.to(torch.float32)

        def updf(p, g, f):
            g = tf32(g)
            g2 = g * g + 1e-30
            if "vr" in f:
                vr = cfg.b2 * f["vr"] + (1 - cfg.b2) * g2.mean(-1)
                vc = cfg.b2 * f["vc"] + (1 - cfg.b2) * g2.mean(-2)
                denom = vr.mean(-1, keepdim=True).clamp_min(1e-30)
                vhat = (vr[..., None] * vc[..., None, :]) / denom[..., None]
                new_f = {"vr": vr, "vc": vc}
            else:
                vhat = cfg.b2 * f["v"] + (1 - cfg.b2) * g2
                new_f = {"v": vhat}
            delta = g / (torch.sqrt(vhat / d2) + cfg.eps)
            # Adafactor update clipping (RMS ≤ 1)
            rms = torch.sqrt(torch.mean(delta**2) + 1e-30)
            delta = delta / rms.clamp_min(1.0)
            if cfg.weight_decay > 0:
                delta = delta + cfg.weight_decay * tf32(p)
            return (tf32(p) - lr * delta).to(p.dtype), new_f

        outs = tree_map(updf, params, grads, state["fac"])
        new_p, new_fac = _split(params, outs, 2)
        new_state = {"fac": new_fac, "step": step}

    elif cfg.name == "sgdm":

        def upds(p, g, m):
            m_new = cfg.momentum * m + tf32(g)
            return (tf32(p) - lr * m_new).to(p.dtype), m_new

        outs = tree_map(upds, params, grads, state["m"])
        new_p, new_m = _split(params, outs, 2)
        new_state = {"m": new_m, "step": step}
    else:
        raise ValueError(cfg.name)

    return new_p, new_state, {"lr": lr, "grad_norm": gnorm}
