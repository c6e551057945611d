"""Continuous-batching serving engine with a JITA-style request scheduler.

A port of ``repro.serve.engine`` with the same scheduling: a pool of
``max_batch`` decode *slots* (the PEs), a queue of requests (the tasks),
and an admission policy from the :data:`SERVE_POLICIES` registry:

  * ``"fcfs"`` — arrival order (the RR-like baseline);
  * ``"eft"``  — the paper's Earliest-Finish-Time rule applied to requests:
    admit the waiting request with the smallest predicted finish
    (prefill_cost·prompt_len + decode_cost·max_new_tokens);
  * ``"edf"``  — earliest deadline first over the request's
    :class:`repro_torch.core.vos.ValueCurve` hard deadline (no curve = no
    deadline = ``+inf``, ordered after every dated request, deterministic
    ``rid`` tie-break).

All requests in flight share one batched KV cache at different depths
(per-row cache indices — repro_torch.models.kvcache); each engine tick
performs at most one prefill (admission) and one batched decode step,
on the device that holds the parameters. The clock is abstract (the
scheduler's cost model), so the engine's bookkeeping equals the
reference's tick for tick. The engine casts the weights that only enter
products to the model's activation type once, at construction
(``repro_torch.models.model.cast_params``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.vos import TIERS, ValueCurve
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import cast_params
from repro_torch.models.transformer import tree_map
from repro_torch.serve.serve_step import (
    build_decode_step,
    build_prefill_step,
    init_serve_caches,
)


@dataclasses.dataclass
class RequestSpec:
    """One inference request with its SLO.

    ``prompt`` is the ``(S,)`` int32 token array — or a bare token *count*
    on scheduling-only paths (the gateway's planner and benchmark never
    materialise prompts; the engine itself requires real tokens). ``tier``
    names the serving class (:data:`repro_torch.core.vos.TIERS`); ``curve`` is
    the request's own :class:`~repro_torch.core.vos.ValueCurve` when the caller
    wants more than the tier's canonical shape. The legacy ``deadline=``
    float init-arg maps to ``ValueCurve.step(deadline)`` with a
    ``DeprecationWarning``.
    """

    rid: int
    prompt: Any                        # (S,) int32 tokens, or int count
    max_new_tokens: int
    arrival: float = 0.0
    tier: str = "batch"
    curve: Optional[ValueCurve] = None
    deadline: dataclasses.InitVar[Optional[float]] = None
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    admitted_at: Optional[float] = None
    finished_at: Optional[float] = None

    def __post_init__(self, deadline: Optional[float]) -> None:
        if self.tier not in TIERS:
            raise ValueError(f"unknown tier {self.tier!r}; one of {TIERS}")
        if deadline is not None:
            warnings.warn(
                "RequestSpec(deadline=...) is deprecated: deadlines are "
                "ValueCurves now — pass curve=ValueCurve.step(deadline)",
                DeprecationWarning, stacklevel=3)
            if self.curve is None:
                self.curve = ValueCurve.step(float(deadline))

    @property
    def prompt_len(self) -> int:
        if isinstance(self.prompt, (int, np.integer)):
            return int(self.prompt)
        return int(len(self.prompt))

    @property
    def hard_deadline(self) -> float:
        """Finish time past which the request earns nothing — ``+inf``
        without a curve (or for curves that never reach 0). The ``edf``
        admission key."""
        if self.curve is None:
            return float("inf")
        return self.curve.hard_deadline()


#: Legacy name of :class:`RequestSpec`, kept importable.
Request = RequestSpec


def _key_fcfs(eng: "ServeEngine", r: RequestSpec) -> Tuple[float, int]:
    return (r.arrival, r.rid)


def _key_eft(eng: "ServeEngine", r: RequestSpec) -> Tuple[float, int]:
    return (eng._predicted_finish(r), r.rid)


def _key_edf(eng: "ServeEngine", r: RequestSpec) -> Tuple[float, int]:
    return (r.hard_deadline, r.rid)


#: Admission-policy registry: name → ``key(engine, request)``; the waiting
#: request minimising the key is admitted next. Replaces the old inline
#: string matching — unknown policies now fail at engine *construction*,
#: and new rules register here instead of patching ``_pick``. Every key
#: must end with ``r.rid`` so ties break deterministically.
SERVE_POLICIES: Dict[str, Callable[["ServeEngine", RequestSpec], Tuple]] = {
    "fcfs": _key_fcfs,
    "eft": _key_eft,
    "edf": _key_edf,
}


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 4
    max_seq: int = 512
    policy: str = "eft"                # a SERVE_POLICIES key
    prefill_cost_per_tok: float = 1.0  # scheduler's cost model (abstract)
    decode_cost_per_tok: float = 5.0
    capacity_factor: float = 4.0
    #: attention through the plain torch version instead of the kernels
    #: (the kernels' oracle; for comparisons only)
    plain_attention: bool = False


class ServeEngine:
    """``vision`` (Nv, d_model), when given, feeds the cross-attention
    blocks, as the reference engine feeds them: each prefill gets
    ``vision[None, 0]`` and each decode tick ``vision`` broadcast over the
    slots."""

    def __init__(self, cfg: ModelConfig, params: Any, ecfg: EngineConfig,
                 vision: Optional[Any] = None) -> None:
        try:
            self._admission_key = SERVE_POLICIES[ecfg.policy]
        except KeyError:
            raise ValueError(
                f"unknown policy {ecfg.policy!r}; one of "
                f"{sorted(SERVE_POLICIES)}") from None
        self.cfg = cfg
        self.ecfg = ecfg
        self.params = cast_params(cfg, params)
        self.device = self.params["embed"]["embedding"].device
        B = ecfg.max_batch
        self._prefill = build_prefill_step(
            cfg, ecfg.capacity_factor, plain_attention=ecfg.plain_attention)
        self._decode = build_decode_step(
            cfg, ecfg.capacity_factor, plain_attention=ecfg.plain_attention)
        self.caches = init_serve_caches(cfg, B, ecfg.max_seq, self.device)
        self.vision = (None if vision is None
                       else torch.as_tensor(vision, device=self.device))
        self.slots: List[Optional[RequestSpec]] = [None] * B
        self.slot_pos = np.zeros(B, np.int32)      # next position per slot
        self.slot_tok = np.zeros(B, np.int32)      # last emitted token
        self.queue: List[RequestSpec] = []
        self.finished: List[RequestSpec] = []
        self.clock = 0.0                           # abstract engine time
        self.ticks = 0

    # -- scheduling --------------------------------------------------------------
    def submit(self, req: RequestSpec) -> None:
        if isinstance(req.prompt, (int, np.integer)):
            raise TypeError(
                "ServeEngine needs real prompt tokens; scheduling-only "
                "RequestSpecs (bare int prompt) belong to the gateway's "
                "planning paths")
        self.queue.append(req)

    def _predicted_finish(self, r: RequestSpec) -> float:
        return (self.clock
                + self.ecfg.prefill_cost_per_tok * r.prompt_len
                + self.ecfg.decode_cost_per_tok * r.max_new_tokens)

    def _pick(self) -> Optional[RequestSpec]:
        ready = [r for r in self.queue if r.arrival <= self.clock]
        if not ready:
            return None
        key = self._admission_key
        r = min(ready, key=lambda r: key(self, r))
        self.queue.remove(r)
        return r

    # -- cache slot surgery ----------------------------------------------------------
    def _insert_slot(self, b: int, fresh: Any) -> None:
        """Copy row 0 of a fresh single-row cache tree into slot b.

        Lead-layer caches are (B, …); scanned-layer caches are stacked
        (R, B, …) — batch is axis 1 there (repro_torch.models.transformer).
        KV rows and Mamba state rows alike; the ``{}`` caches of
        cross-attention blocks have no leaves. Written in place.
        """
        def ins_lead(c, u):
            c[b] = u[0].to(c.dtype)

        def ins_scan(c, u):
            c[:, b] = u[:, 0].to(c.dtype)

        tree_map(ins_lead, self.caches["lead"], fresh["lead"])
        tree_map(ins_scan, self.caches["scan"], fresh["scan"])

    # -- one engine tick ----------------------------------------------------------------
    def step(self) -> Dict[str, Any]:
        self.ticks += 1
        admitted = None

        # 1) admission + prefill into a free slot
        free = [i for i, s in enumerate(self.slots) if s is None]
        if free:
            req = self._pick()
            if req is not None:
                b = free[0]
                prompt = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                         device=self.device)[None]
                fresh = init_serve_caches(self.cfg, 1, self.ecfg.max_seq,
                                          self.device)
                vis = (self.vision[None, 0] if self.vision is not None else None)
                vis = vis[None] if (vis is not None and vis.ndim == 2) else vis
                logits, fresh = self._prefill(self.params, prompt, fresh,
                                              vision=vis)
                first = int(torch.argmax(logits[0]))
                self._insert_slot(b, fresh)
                req.output.append(first)
                req.admitted_at = self.clock
                self.slots[b] = req
                self.slot_pos[b] = req.prompt_len
                self.slot_tok[b] = first
                admitted = req.rid
                self.clock += self.ecfg.prefill_cost_per_tok * req.prompt_len

        # 2) one batched decode step over active slots
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if active:
            tok = torch.as_tensor(self.slot_tok, device=self.device)
            pos = torch.as_tensor(self.slot_pos, device=self.device)
            vis = None
            if self.vision is not None:
                vis = self.vision[None].expand(
                    (len(self.slots),) + tuple(self.vision.shape))
            nxt, _, self.caches = self._decode(self.params, tok, pos,
                                               self.caches, vision=vis)
            nxt = nxt.cpu().numpy()
            for b in active:
                r = self.slots[b]
                r.output.append(int(nxt[b]))
                self.slot_pos[b] += 1
                self.slot_tok[b] = int(nxt[b])
                if len(r.output) >= r.max_new_tokens + 1:
                    r.finished_at = self.clock
                    self.finished.append(r)
                    self.slots[b] = None
            self.clock += self.ecfg.decode_cost_per_tok
        elif admitted is None and self.queue:
            # idle engine, every queued request still in the future: jump
            # to the next arrival instead of spinning the tick budget away
            self.clock = min(r.arrival for r in self.queue)

        return {"admitted": admitted, "active": len(active),
                "queued": len(self.queue), "finished": len(self.finished)}

    def run(self, max_ticks: int = 10000) -> List[RequestSpec]:
        while (self.queue or any(s is not None for s in self.slots)) \
                and self.ticks < max_ticks:
            self.step()
        return self.finished

    # -- metrics ---------------------------------------------------------------------
    def latency_stats(self) -> Dict[str, float]:
        """Latency summary over finished requests — always the full key
        set, zeros (not ``{}``) when nothing has finished, so callers can
        index unconditionally."""
        lats = [r.finished_at - r.arrival for r in self.finished
                if r.finished_at is not None]
        waits = [r.admitted_at - r.arrival for r in self.finished
                 if r.admitted_at is not None]
        if not lats:
            return {"mean_latency": 0.0, "p95_latency": 0.0,
                    "mean_wait": 0.0, "n": 0}
        return {"mean_latency": float(np.mean(lats)),
                "p95_latency": float(np.percentile(lats, 95)),
                "mean_wait": float(np.mean(waits)) if waits else 0.0,
                "n": len(lats)}
