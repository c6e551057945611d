"""KV caches for serving, in the layout of ``repro.models.kvcache``.

One cache dict per attention layer:

  * ``k`` / ``v`` — (B, C, Hkv, D) slots; C = capacity. C ≥ max_seq gives a
    dense cache; C = sliding_window gives a **ring** cache (SWA archs).
  * ``pos`` — (B, C) absolute position stored in each slot (−1 = empty);
    feeds the causal/window masks directly, so ring wraparound needs no
    special-casing in the attention math.
  * ``idx`` — (B,) int32, monotone per-row count of tokens written, so a
    continuous-batching engine can hold requests at different depths in
    one batched cache (``repro_torch.serve.engine``).

Unlike the JAX version, :func:`update_cache` writes in place: the cache
tensors (or the views of a stacked cache that the backbone hands it) are
updated and returned, never copied. The one-token write is an indexed
store of B rows, not the JAX version's where-update over the whole cache.

A cache sharded on its capacity (``cache_cap`` over "model",
``repro_torch.distributed``) holds on each rank only the block of slots
``[start, start + C_local)`` of the global ring of C slots; ``shard=(start,
C)`` makes :func:`update_cache` write only the ring slots (``idx % C``)
that fall in the rank's block, so the cache never leaves the rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig

Cache = Dict[str, torch.Tensor]


def init_kv_cache(
    cfg: ModelConfig,
    batch: int,
    capacity: int,
    dtype: Optional[torch.dtype] = None,
    device: object = "cpu",
) -> Cache:
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, capacity), -1, dtype=torch.int32, device=device),
        "idx": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def layer_capacity(cfg: ModelConfig, local: bool, max_seq: int) -> int:
    """Ring capacity for local layers, dense for global ones."""
    if local and cfg.sliding_window > 0:
        return min(cfg.sliding_window, max_seq)
    return max_seq


def update_cache(
    cache: Cache,
    k: torch.Tensor,
    v: torch.Tensor,
    positions: torch.Tensor,
    shard: Optional[Tuple[int, int]] = None,
) -> Tuple[Cache, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write S new kv entries at ring slots, in place; return the cache view.

    k/v: (B, S, Hkv, D); positions: (B, S) absolute. Returns
    (cache, k_all, v_all, pos_all, valid_all) where *_all are the (B, C)
    capacity views the attention reads. ``shard=(start, C)``: the cache
    holds the slots ``[start, start + C_local)`` of a ring of C slots.
    """
    b, c = cache["k"].shape[:2]
    s = k.shape[1]
    rows = torch.arange(b, device=k.device)
    if shard is not None:
        _update_block(cache, k, v, positions, rows, *shard)
    elif s == 1:
        slot = (cache["idx"] % c).long()
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][rows, slot] = positions[:, 0].to(torch.int32)
    else:
        if s >= c:
            # segment longer than the ring: only the last C tokens survive;
            # the tail keeps the slots of one write unique
            k, v, positions = k[:, -c:], v[:, -c:], positions[:, -c:]
            offs = torch.arange(c, device=k.device) + (s - c)
        else:
            offs = torch.arange(s, device=k.device)
        slots = (cache["idx"].long()[:, None] + offs[None]) % c
        cache["k"][rows[:, None], slots] = k.to(cache["k"].dtype)
        cache["v"][rows[:, None], slots] = v.to(cache["v"].dtype)
        cache["pos"][rows[:, None], slots] = positions.to(torch.int32)
    cache["idx"] += s
    return cache, cache["k"], cache["v"], cache["pos"], cache["pos"] >= 0


def _update_block(
    cache: Cache,
    k: torch.Tensor,
    v: torch.Tensor,
    positions: torch.Tensor,
    rows: torch.Tensor,
    start: int,
    cap: int,
) -> None:
    """The ring write of :func:`update_cache` restricted to the rank's
    block of slots ``[start, start + C_local)`` of a ring of ``cap``."""
    c = cache["k"].shape[1]
    s = k.shape[1]
    news = {"k": k, "v": v, "pos": positions.to(torch.int32)}
    if s == 1:
        # one slot a row: store the new entry where the rank owns the
        # slot, and the slot's own value back elsewhere
        local = (cache["idx"].long() % cap) - start
        own = (local >= 0) & (local < c)
        local = local.clamp(0, c - 1)
        for name, new in news.items():  # det: ok fixed keys
            t = cache[name]
            keep = t[rows, local]
            hit = own.view((-1,) + (1,) * (keep.dim() - 1))
            t[rows, local] = torch.where(hit, new[:, 0].to(t.dtype), keep)
        return
    # a segment: the last n tokens survive; token j lands on ring slot
    # (base + j) % cap, so each of the block's slots reads the token that
    # lands on it (if any): a gather, with no two writes to one slot
    n = min(s, cap)
    base = cache["idx"].long() + (s - n)
    slots = torch.arange(start, start + c, device=k.device)
    j = (slots[None] - base[:, None]) % cap  # (B, C_local)
    hit = j < n
    j = j.clamp(max=n - 1) + (s - n)
    for name, new in news.items():  # det: ok fixed keys
        t = cache[name]
        got = new[rows[:, None], j].to(t.dtype)
        t.copy_(torch.where(hit.view(hit.shape + (1,) * (t.dim() - 2)), got, t))
