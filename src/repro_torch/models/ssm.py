"""Mamba-1 selective SSM block (falcon-mamba, jamba).

A port of ``repro.models.ssm``. Recurrence (per channel c, state dim n):

    h_t = exp(Δ_t A) ⊙ h_{t-1} + Δ_t B_t x_t
    y_t = C_t · h_t + D x_t

with input-dependent Δ, B, C ("selective"). The sequence is processed in
chunks of ``cfg.ssm_chunk``, the reference's rule exactly: a loop carries
the state across chunks, and within a chunk a log-depth doubling scan
(Hillis–Steele, ⌈log2 chunk⌉ steps over the whole chunk at once) takes
the place of ``lax.associative_scan``. That bounds the materialised
(B, chunk, d_inner, N) tensors and keeps a prefill on the card to a few
dozen launches a layer. The scan state is float32 whatever the
activation type. The reference computes the scan outside any Pallas
kernel, and so does the port.

Decode path: an O(1) single-token state update and a (conv_w − 1)-deep
causal conv ring, the "KV cache" of an SSM arch.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain
from repro_torch.kernels._build import requires_grad
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def init_mamba(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    d, di, n, r, c = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    std = 1.0 / math.sqrt(d)
    pd = L._dtype(cfg.param_dtype)
    # S4D-real initialisation for A; dt bias ~ softplus^-1(uniform dt range)
    a_init = torch.arange(1, n + 1, dtype=torch.float32, device=device)[None].repeat(di, 1)
    u = torch.rand((di,), generator=gen, device=device, dtype=torch.float32)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    return {
        "in_proj": L._normal(cfg, (d, 2 * di), std, gen, device),
        "conv_w": L._normal(cfg, (c, di), 1.0 / math.sqrt(c), gen, device),
        "conv_b": torch.zeros((di,), dtype=pd, device=device),
        "x_proj": L._normal(cfg, (di, r + 2 * n), 1.0 / math.sqrt(di), gen, device),
        "dt_proj": L._normal(cfg, (r, di), 1.0 / math.sqrt(r), gen, device),
        "dt_bias": dt_bias.to(pd),
        "A_log": torch.log(a_init).to(pd),
        "D": torch.ones((di,), dtype=pd, device=device),
        "out_proj": L._normal(cfg, (di, d), std / math.sqrt(2 * cfg.n_layers), gen, device),
    }


def init_ssm_state(cfg: ModelConfig, batch: int, device="cpu") -> Dict[str, torch.Tensor]:
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32, device=device),
        "conv": torch.zeros(
            (batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=L._dtype(cfg.dtype), device=device
        ),
    }


def _causal_conv(
    cfg: ModelConfig, p: Params, x: torch.Tensor, conv_state: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over seq. x: (B, S, di) → (y, new_conv_state)."""
    c = cfg.ssm_conv
    w = p["conv_w"].to(x.dtype)  # (c, di)
    if conv_state is None:
        head = torch.zeros((x.shape[0], c - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        head = conv_state.to(x.dtype)
    xp = torch.cat([head, x], dim=1)  # (B, S+c-1, di)
    s = x.shape[1]
    y = sum(xp[:, j : j + s] * w[j][None, None, :] for j in range(c))
    y = y + p["conv_b"].to(x.dtype)
    new_state = xp[:, -(c - 1) :] if c > 1 else head
    return y, new_state


def _ssm_inputs(
    cfg: ModelConfig, p: Params, u: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """u: (B, S, di) → (dA, dBu, C, u) terms of the recurrence, f32."""
    n, r = cfg.ssm_state, cfg.dt_rank
    uf = u.float()
    proj = uf @ p["x_proj"].float()  # (B,S,r+2n)
    dt_r, bm, cm = proj[..., :r], proj[..., r : r + n], proj[..., r + n :]
    dt = F.softplus(dt_r @ p["dt_proj"].float() + p["dt_bias"].float())  # (B,S,di)
    a = -torch.exp(p["A_log"].float())  # (di, n)
    da = torch.exp(dt[..., None] * a[None, None])  # (B,S,di,n)
    dbu = (dt * uf)[..., None] * bm[:, :, None, :]  # (B,S,di,n)
    return da, dbu, cm, uf


def _scan_chunk(
    da: torch.Tensor, dbu: torch.Tensor, h0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Within-chunk scan. h_t = dA_t h_{t-1} + dBu_t, h_{-1} = h0.

    Hillis–Steele: after the step of offset o, position t holds the
    composition of positions t−2o+1 … t, so ⌈log2 chunk⌉ steps give the
    inclusive prefix (A_cum, B_cum) of the reference's
    ``associative_scan``. Serving overwrites ``da`` and ``dbu`` in place;
    under autograd, which saved their earlier values, each step builds
    new tensors from the same products and sums."""
    a, b = da, dbu
    inplace = not requires_grad(da, dbu, h0)
    off = 1
    while off < a.shape[1]:
        if inplace:
            b[:, off:] += b[:, :-off] * a[:, off:]  # reads the previous step's a
            a[:, off:] = a[:, off:] * a[:, :-off]
        else:
            b = torch.cat([b[:, :off], b[:, off:] + b[:, :-off] * a[:, off:]], dim=1)
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    h = a * h0[:, None] + b  # (B,C,di,n)
    return h, h[:, -1]


def apply_mamba(
    cfg: ModelConfig, p: Params, x: torch.Tensor, state: Optional[Dict[str, torch.Tensor]] = None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) → (y, new_state). S = 1 routes to the O(1) decode path.

    ``state`` is read, not written: the caller stores the new state."""
    bsz, s, _ = x.shape
    dt = x.dtype
    xz = x @ p["in_proj"].to(dt)  # (B,S,2di)
    u, z = xz.chunk(2, dim=-1)
    u = constrain(u, "batch", None, "d_inner")

    conv_state = state["conv"] if state is not None else None
    u, new_conv = _causal_conv(cfg, p, u, conv_state)
    u = F.silu(u)

    if state is not None:
        h0 = state["h"]
    else:
        h0 = torch.zeros((bsz, cfg.d_inner, cfg.ssm_state), dtype=torch.float32, device=x.device)

    if s == 1:  # decode fast path
        da, dbu, cm, _ = _ssm_inputs(cfg, p, u)
        h = da[:, 0] * h0 + dbu[:, 0]  # (B,di,n)
        y = torch.einsum("bdn,bn->bd", h, cm[:, 0])[:, None]
        h_last = h
    else:
        chunk = min(cfg.ssm_chunk, s)
        if s % chunk != 0:
            chunk = s  # fallback: single chunk (small seqs)
        ys = []
        h_last = h0
        for c0 in range(0, s, chunk):
            da, dbu, cm, _ = _ssm_inputs(cfg, p, u[:, c0 : c0 + chunk])
            hs, h_last = _scan_chunk(da, dbu, h_last)
            ys.append(torch.einsum("bcdn,bcn->bcd", hs, cm))
            del hs, da, dbu
        y = torch.cat(ys, dim=1)

    y = (y + u.float() * p["D"].float()[None, None]).to(dt)
    y = y * F.silu(z)
    out = y @ p["out_proj"].to(dt)
    return out, {"h": h_last, "conv": new_conv}
