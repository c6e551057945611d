"""Logical-axis sharding with divisibility fallback, over a ``DeviceMesh``.

A port of ``repro.distributed.sharding``. Model code annotates tensors with
*logical* axes ("batch", "heads", "d_ff", "expert", …); a per-architecture
**strategy** maps logical axes to mesh axes; :func:`resolve` turns
(logical axes, shape) into a :class:`PartitionSpec`, dropping any mapping
whose dimension is not divisible by the mesh-axis extent. The rules, the
strategies and their notes are the reference's, except for the per-card
memory that decides FSDP (:data:`HBM_BYTES`, an H100's 80 GB).

How a spec places a tensor: a spec holds, per tensor dimension, one mesh
axis name, a tuple of names (major → minor) or None. :func:`placements`
turns it into DTensor placements (``Shard(i)`` on each mesh dimension
named at tensor dimension ``i``, else ``Replicate()``), and
:func:`local_block` cuts a rank's block out of a whole tensor in the
reference's order, major axis first.

How the port executes under rules. A rank holds plain tensors, its own
blocks; DTensors appear only at the edges (:func:`param_shardings`,
``core.elastic.reshard``, ``CheckpointManager.restore(shardings=)`` and
DTensor arguments of ``compat.shard_map``). The dense layers run on
whatever weights the rank holds, whole in the serving paths. Two paths
read the rules and communicate, as in the reference:
``layers.sharded_decode_attention`` (the decode cache sharded on its
capacity over "model") and ``moe.apply_moe_shard_map`` (experts or the
expert FF over "model"). There a plain activation's batch dimension is
the rank's block of a batch sharded over the rules' batch axes, and
``transformer.init_caches`` under rules allocates the rank's block of the
cache; both need the global batch and capacity to divide evenly.

Outside :func:`logical_axis_rules` every :func:`constrain` is the
identity; inside, a DTensor is redistributed to the spec's placements and
a plain tensor, a rank's block, is returned as it is: constrain never
changes a value.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.config import ModelConfig

#: a rule value: mesh axis name, tuple of names (major→minor), or None
Rule = Union[None, str, Tuple[str, ...]]

_CTX = threading.local()


class PartitionSpec(tuple):
    """One rule per tensor dimension, as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts: Rule) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A mesh and a spec: a leaf's layout, as ``jax.sharding.NamedSharding``."""

    def __init__(self, mesh: DeviceMesh, spec: PartitionSpec) -> None:
        self.mesh = mesh
        self.spec = spec

    def placements(self, ndim: int) -> tuple:
        return placements(self.spec, self.mesh, ndim)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.mesh_dim_names}, {self.spec!r})"


def _axes(rule: Rule) -> Tuple[str, ...]:
    if rule is None:
        return ()
    return (rule,) if isinstance(rule, str) else tuple(rule)


def placements(spec: Sequence[Rule], mesh: DeviceMesh, ndim: Optional[int] = None) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each mesh
    dimension named at tensor dimension ``i``, ``Replicate()`` elsewhere.

    DTensor orders several mesh dimensions on one tensor dimension by the
    mesh's own order, so a spec that names them in another order has no
    placements (it raises); :func:`local_block` cuts such blocks by hand."""
    names = tuple(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dims")
    for i, rule in enumerate(spec):
        axes = _axes(rule)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec entry {axes} is not in the mesh's order {names}")
        for a in axes:
            out[names.index(a)] = Shard(i)
    return tuple(out)


def _coordinate(mesh: DeviceMesh) -> Dict[str, int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, coord, strict=True))


def block_range(rule: Rule, dim: int, mesh: DeviceMesh,
                coord: Optional[Mapping[str, int]] = None) -> Tuple[int, int]:
    """The rank's ``[start, stop)`` of a tensor dimension of size ``dim``
    sharded by ``rule``, major axis first (the reference's block order)."""
    coord = _coordinate(mesh) if coord is None else coord
    size = dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape), strict=True))
    index, extent = 0, 1
    for a in _axes(rule):
        index = index * size[a] + int(coord[a])
        extent *= size[a]
    if dim % extent:
        raise ValueError(f"dimension {dim} does not divide over {rule} ({extent})")
    step = dim // extent
    return index * step, (index + 1) * step


def local_block(x: torch.Tensor, spec: Sequence[Rule], mesh: DeviceMesh,
                coord: Optional[Mapping[str, int]] = None) -> torch.Tensor:
    """The rank's block (a view) of the whole tensor ``x`` under ``spec``."""
    for i, rule in enumerate(spec):
        if rule is not None:
            lo, hi = block_range(rule, x.shape[i], mesh, coord)
            x = x.narrow(i, lo, hi - lo)
    return x


def distribute(x: torch.Tensor, spec: Sequence[Rule], mesh: DeviceMesh) -> DTensor:
    """A DTensor of ``x``'s value with ``spec``'s layout, from the whole
    tensor that every rank holds: each rank keeps its block, no rank
    sends anything."""
    local = local_block(x, spec, mesh).contiguous()
    return DTensor.from_local(local, mesh, placements(spec, mesh, x.ndim), run_check=False,
                              shape=x.shape, stride=x.contiguous().stride())


def current_rules() -> Optional["ShardingRules"]:
    return getattr(_CTX, "rules", None)


class ShardingRules:
    """Logical-axis → mesh-axis mapping bound to a mesh.

    ``options`` carries strategy switches the model layer consults
    (e.g. ``moe_shard_map``, ``decode_flash_shard``) — the §Perf paths.
    """

    def __init__(self, rules: Mapping[str, Rule], mesh: DeviceMesh,
                 notes: str = "",
                 options: Optional[Dict[str, Any]] = None) -> None:
        self.rules = dict(rules)
        self.mesh = mesh
        self.notes = notes
        self.options = dict(options or {})
        self.axis_size = dict(zip(mesh.mesh_dim_names,
                                  (int(s) for s in mesh.shape),
                                  strict=True))

    def _extent(self, rule: Rule) -> int:
        if rule is None:
            return 1
        if isinstance(rule, str):
            return self.axis_size[rule]
        return int(np.prod([self.axis_size[a] for a in rule]))

    def dim_rule(self, logical: Optional[str], dim: int) -> Rule:
        """Resolve one dimension with divisibility fallback: full rule →
        tuple prefixes → None."""
        if logical is None:
            return None
        rule = self.rules.get(logical)
        if rule is None:
            return None
        candidates: List[Rule] = [rule]
        if isinstance(rule, tuple):
            candidates += [rule[:i] for i in range(len(rule) - 1, 0, -1)]
        for cand in candidates:
            ext = self._extent(cand)
            if ext > 1 and dim % ext == 0:
                return cand if not (isinstance(cand, tuple) and len(cand) == 1) \
                    else cand[0]
        return None

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Sequence[int]) -> PartitionSpec:
        if len(logical_axes) != len(shape):
            raise ValueError(f"rank mismatch: {logical_axes} vs shape {shape}")
        used: set = set()
        out: List[Rule] = []
        for name, dim in zip(logical_axes, shape, strict=True):
            r = self.dim_rule(name, int(dim))
            # a mesh axis may appear at most once in a PartitionSpec
            flat = (r,) if isinstance(r, str) else (r or ())
            if any(a in used for a in flat):
                r = None
            else:
                used.update(flat)
            out.append(r)
        return P(*out)


@contextlib.contextmanager
def logical_axis_rules(rules: Union[ShardingRules, Mapping[str, Rule]],
                       mesh: Optional[DeviceMesh] = None):
    """Bind sharding rules for the enclosed region (thread-local)."""
    if not isinstance(rules, ShardingRules):
        if mesh is None:
            raise ValueError("mesh required when passing a raw rule mapping")
        rules = ShardingRules(rules, mesh)
    prev = getattr(_CTX, "rules", None)
    _CTX.rules = rules
    try:
        yield rules
    finally:
        _CTX.rules = prev


def resolve(logical_axes: Sequence[Optional[str]],
            shape: Sequence[int]) -> Optional[PartitionSpec]:
    rules = current_rules()
    if rules is None:
        return None
    return rules.spec(logical_axes, shape)


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Annotate an intermediate with logical axes: the identity outside
    rules and on a plain tensor (a rank's block); a DTensor is
    redistributed to the spec's placements. Never changes a value."""
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    want = placements(rules.spec(logical_axes, x.shape), rules.mesh, x.ndim)
    return x if tuple(x.placements) == want else x.redistribute(rules.mesh, want)


# ---------------------------------------------------------------------------
# Per-architecture strategies (DESIGN.md §5)
# ---------------------------------------------------------------------------

#: HBM per H100 card; param-plane budget used to decide FSDP-style sharding
HBM_BYTES = 80e9
PARAM_BUDGET_FRACTION = 0.35


def strategy_for(cfg: ModelConfig, mesh: DeviceMesh, *,
                 sequence_sharding: bool = False,
                 force_fsdp: Optional[bool] = None,
                 mode: str = "tp",
                 moe_shard_map: bool = False,
                 decode_flash_shard: bool = False) -> ShardingRules:
    """Build the sharding strategy for ``cfg`` on ``mesh``.

    * DP: batch over ("pod","data") — hierarchical gradient reduction.
    * TP: heads / d_ff / vocab / d_inner over "model" where divisible;
      GQA kv-heads usually < TP degree → kv replicated (MaxText-style
      kv-head replication), documented in notes.
    * EP: experts over "model" when divisible (kimi 384, jamba 16);
      else experts replicate and the expert FF dim takes TP (mixtral 8).
    * FSDP: when master params would exceed the per-card budget under pure
      TP (kimi-k2 1T), FF/expert-FF fan-ins additionally shard over the
      data axis (ZeRO-3-style), at the cost of per-layer all-gathers.
    * SP: optional sequence sharding over "model" between blocks
      (Megatron-SP analogue; used by the 32k-prefill perf configs).
    """
    names = tuple(mesh.mesh_dim_names)
    tp_axis = "model" if "model" in names else None
    dp: Tuple[str, ...] = tuple(a for a in ("pod", "data") if a in names)
    size = dict(zip(names, (int(s) for s in mesh.shape), strict=True))
    tp = size.get("model", 1)

    notes: List[str] = []

    if mode == "fsdp":
        # pure ZeRO-3: no tensor parallelism — batch over every mesh axis,
        # every weight sharded on its fan-in dim over the mesh without the
        # pod axis (per-layer weight gathers stay inside a pod), the vocab
        # head kept on "model" (Megatron-style); the reference's strategy
        wt_ax: Tuple[str, ...] = tuple(a for a in names if a != "pod")
        batch_ax = tuple(a for a in ("data", "model", "pod") if a in names)
        rules: Dict[str, Rule] = {
            "batch": batch_ax, "seq": None,
            "vocab": (tp_axis if tp_axis and cfg.vocab_size % tp == 0
                      else wt_ax),
            "d_model": wt_ax, "d_model_fsdp": wt_ax,
            "heads": wt_ax, "kv_heads": wt_ax, "kv_head_dim": None,
            "d_ff": wt_ax, "expert": wt_ax, "moe_ff": wt_ax,
            "moe_cap": None, "d_inner": wt_ax, "layers": None,
            "state": None, "vision_tokens": None, "cache_cap": None,
        }
        notes.append("mode=fsdp: ZeRO-3 — params sharded on fan-in dims "
                     "over the flat mesh, per-layer all-gathers; no TP "
                     "except the vocab head (Megatron-style)")
        return ShardingRules(rules, mesh, notes="; ".join(notes),
                             options={"moe_shard_map": moe_shard_map})

    def div(n: int, label: str) -> Optional[str]:
        if tp_axis and n % tp == 0:
            return tp_axis
        notes.append(f"{label} ({n}) not divisible by TP={tp} → replicated")
        return None

    heads_rule = div(cfg.n_heads, "q-heads") if cfg.has_attention else None
    kv_rule = None
    kv_dim_rule = None
    if cfg.has_attention:
        if cfg.n_kv_heads % tp == 0:
            kv_rule = tp_axis
        elif tp_axis and cfg.head_dim % tp == 0:
            # decode caches: shard head_dim instead (partial-contraction
            # attention; scores all-reduce is tiny vs streaming the cache)
            kv_dim_rule = tp_axis
            notes.append(f"kv-heads ({cfg.n_kv_heads}) < TP={tp} → kv "
                         f"weights replicated; decode cache sharded over "
                         f"head_dim ({cfg.head_dim})")
        else:
            notes.append(f"kv-heads ({cfg.n_kv_heads}) < TP={tp} → "
                         "kv replicated (kv-head replication)")

    # EP vs TP-over-ff for MoE
    expert_rule: Rule = None
    moe_ff_rule: Rule = None
    if cfg.n_experts:
        if tp_axis and cfg.n_experts % tp == 0:
            expert_rule = tp_axis
            notes.append(f"EP: {cfg.n_experts} experts over TP={tp}")
        else:
            moe_ff_rule = div(cfg.expert_d_ff, "expert-ff")
            notes.append(f"{cfg.n_experts} experts < TP={tp} → experts "
                         "replicated, expert-ff TP-sharded")

    # FSDP decision from the analytic param count
    pbytes = cfg.param_counts()["total"] * (2 if cfg.param_dtype == "bfloat16" else 4)
    budget = HBM_BYTES * PARAM_BUDGET_FRACTION
    fsdp = force_fsdp if force_fsdp is not None else (pbytes / max(tp, 1) > budget)
    fsdp_rule: Rule = dp if (fsdp and dp) else None
    if fsdp:
        notes.append(f"FSDP: master params {pbytes/1e9:.0f} GB / TP={tp} "
                     f"exceeds {budget/1e9:.1f} GB budget → fan-in dims "
                     f"sharded over {dp}")
        if expert_rule is not None and moe_ff_rule is None:
            moe_ff_rule = dp
    rules: Dict[str, Rule] = {
        "batch": dp or None,
        "seq": (tp_axis if sequence_sharding else None),
        "vocab": div(cfg.vocab_size, "vocab"),
        "d_model": None,
        "d_model_fsdp": fsdp_rule,          # fan-in dim of big FF weights
        "heads": heads_rule,
        "kv_heads": kv_rule,
        "kv_head_dim": kv_dim_rule,
        "d_ff": div(cfg.d_ff, "d_ff"),
        "expert": expert_rule,
        "moe_ff": moe_ff_rule if moe_ff_rule is not None else (
            div(cfg.expert_d_ff, "moe-ff") if cfg.n_experts and not expert_rule
            else (dp if fsdp and cfg.n_experts else None)),
        "moe_cap": dp or None,
        "d_inner": (div(cfg.d_inner, "d_inner")
                    if cfg.family in ("ssm", "hybrid") else None),
        "layers": None,
        "state": None,
        "vision_tokens": None,
        "cache_cap": None,
    }
    if decode_flash_shard and tp_axis:
        # shard the decode KV cache on its CAPACITY dim; attention runs
        # shard-local flash-decode and merges (m, l, acc) stats
        # (repro_torch.models.layers.sharded_decode_attention)
        rules["cache_cap"] = tp_axis
        rules["kv_head_dim"] = None
        rules["kv_heads"] = None
        notes.append("decode cache sharded over capacity (flash-decode "
                     "stat merge)")
    return ShardingRules(rules, mesh, notes="; ".join(notes),
                         options={"moe_shard_map": moe_shard_map,
                                  "decode_flash_shard": decode_flash_shard})


# ---------------------------------------------------------------------------
# Param tree → PartitionSpec tree
# ---------------------------------------------------------------------------

#: leaf-name → logical axes, disambiguated by parent module kind + rank.
def _leaf_axes(path: Tuple[str, ...], ndim: int) -> Tuple[Optional[str], ...]:
    name = path[-1]
    parents = set(path[:-1])
    stacked = ndim >= 1 and ("scan" in parents)

    # optimizer-state leaves: adafactor's factored moments drop one dim of
    # the underlying param (path[-2] is the param name); adamw's m/v mirror
    # the param exactly (their leaf names ARE the param names, handled by
    # the normal rules below); int8 state blocks (q/s) replicate.
    if name in ("vr", "vc") and len(path) >= 2:
        base_full = _leaf_axes(path[:-1], ndim + 1)
        return base_full[:-1] if name == "vr" else \
            base_full[:-2] + base_full[-1:]
    base: Tuple[Optional[str], ...]

    def attn() -> Tuple[Optional[str], ...]:
        if name == "wq":
            return ("d_model", "heads")
        if name in ("wk", "wv"):
            return ("d_model", "kv_heads")
        if name == "wo":
            return ("heads", "d_model")
        if name in ("bq",):
            return ("heads",)
        if name in ("bk", "bv"):
            return ("kv_heads",)
        if name in ("bo",):
            return ("d_model",)
        return (None,)  # q_norm / k_norm (head_dim,)

    def mlp() -> Tuple[Optional[str], ...]:
        if name in ("wi", "wg"):
            return ("d_model_fsdp", "d_ff")
        if name == "wo":
            return ("d_ff", "d_model")
        return ("d_ff",)

    def moe() -> Tuple[Optional[str], ...]:
        if name == "router":
            return ("d_model", None)
        if name in ("wi", "wg"):
            return ("expert", "d_model_fsdp", "moe_ff")
        if name == "wo":
            return ("expert", "moe_ff", "d_model")
        return (None,)

    def mamba() -> Tuple[Optional[str], ...]:
        return {
            "in_proj": ("d_model", "d_inner"),
            "conv_w": (None, "d_inner"),
            "conv_b": ("d_inner",),
            "x_proj": ("d_inner", None),
            "dt_proj": (None, "d_inner"),
            "dt_bias": ("d_inner",),
            "A_log": ("d_inner", None),
            "D": ("d_inner",),
            "out_proj": ("d_inner", "d_model"),
        }.get(name, (None,))

    if name == "embedding":
        base = ("vocab", "d_model")
    elif name == "lm_head":
        base = ("d_model", "vocab")
    elif "moe" in parents and "shared" not in parents:
        base = moe()
    elif "mamba" in parents:
        base = mamba()
    elif "attn" in parents or "xattn" in parents:
        base = attn()
    elif "mlp" in parents or "shared" in parents:
        base = mlp()
    else:  # norms, scalars
        base = (None,) * ndim

    want = ndim - (1 if stacked else 0)
    if len(base) != want:  # rank drift (e.g. biases) → replicate
        base = (None,) * want
    if stacked:
        base = ("layers",) + base
    return base


def _map_with_path(fn, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path names, leaf)`` over a tree of dicts and lists/tuples; a
    name is a dict key or a list index, as ``_path_names`` gives them in
    the reference."""
    if isinstance(tree, dict):
        items = tree.items()  # det: ok key-addressed rebuild, the tree's own order
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in items}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _ndim(leaf: Any) -> int:
    return len(_shape(leaf))


def _shape(leaf: Any) -> Tuple[int, ...]:
    return tuple(int(s) for s in leaf.shape)


def param_specs(params, rules: Optional[ShardingRules] = None):
    """PartitionSpec tree for a model param tree (divisibility-safe)."""
    rules = rules or current_rules()
    if rules is None:
        raise ValueError("no sharding rules in context")

    def one(names, leaf):
        axes = _leaf_axes(names, _ndim(leaf))
        return rules.spec(axes, _shape(leaf))

    return _map_with_path(one, params)


def param_shardings(params, rules: Optional[ShardingRules] = None):
    """:class:`NamedSharding` tree for a model param tree; each leaf's
    ``placements(ndim)`` are its DTensor placements."""
    rules = rules or current_rules()

    def one(names, leaf):
        return NamedSharding(rules.mesh, rules.spec(_leaf_axes(names, _ndim(leaf)), _shape(leaf)))

    return _map_with_path(one, params)


# ---------------------------------------------------------------------------
# Cache / batch specs (serving and launchers)
# ---------------------------------------------------------------------------

#: kv / ssm cache leaf name → logical axes (batch axis explicit; scanned
#: cache leaves get the extra leading "layers" dim like params do).
_CACHE_AXES = {
    "k": ("batch", "cache_cap", "kv_heads", "kv_head_dim"),
    "v": ("batch", "cache_cap", "kv_heads", "kv_head_dim"),
    "pos": ("batch", "cache_cap"),
    "idx": ("batch",),
    "h": ("batch", "d_inner", None),
    "conv": ("batch", None, "d_inner"),
}


def cache_specs(caches, rules: Optional[ShardingRules] = None):
    """PartitionSpec tree for a repro_torch.models.transformer cache tree."""
    rules = rules or current_rules()
    if rules is None:
        raise ValueError("no sharding rules in context")

    def one(names, leaf):
        axes = _CACHE_AXES.get(names[-1])
        if axes is None:
            return rules.spec((None,) * _ndim(leaf), _shape(leaf))
        if "scan" in names[:-1]:
            axes = ("layers",) + axes
        if len(axes) != _ndim(leaf):
            axes = (None,) * _ndim(leaf)
        return rules.spec(axes, _shape(leaf))

    return _map_with_path(one, caches)


def batch_specs(batch, rules: Optional[ShardingRules] = None):
    """Specs for a train/serve input batch: leading dim = batch, others
    replicated (tokens/labels (B,S); vision (B,Nv,d); pos (B,))."""
    rules = rules or current_rules()

    def one(_, leaf):
        nd = _ndim(leaf)
        return rules.spec(("batch",) + (None,) * (nd - 1), _shape(leaf))

    return _map_with_path(one, batch)


def sharded_extent(rules: ShardingRules, logical: str) -> int:
    """How many blocks the rules' full rule for ``logical`` cuts a
    dimension into (1 when it has no rule)."""
    return rules._extent(rules.rules.get(logical))


def block_start(rules: ShardingRules, logical: str, local_dim: int) -> int:
    """The first global index of the rank's block of a dimension whose
    local size is ``local_dim``, sharded by the full rule of ``logical``."""
    rule = rules.rules.get(logical)
    n = rules._extent(rule)
    return block_range(rule, local_dim * n, rules.mesh)[0] if n > 1 else 0

