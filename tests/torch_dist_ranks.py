"""Process groups and rank bodies for the port's distributed tests.

Not a test module: ``tests/test_torch_distributed.py`` and
``tests/test_torch_perf_paths.py`` hand these functions to
``repro_torch.distributed.spawn.run_ranks``, whose spawned ranks import
them by name (this module imports no JAX, so a rank starts light). Each
body takes the reference's values as numpy arrays from a pickle the
test's JAX subprocess wrote, and returns numpy arrays and floats.
"""

from __future__ import annotations

import contextlib
import pickle

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.compat import set_mesh
from repro_torch.models.config import ModelConfig


@contextlib.contextmanager
def process_group(backend: str, world: int):
    """A default process group of ``world`` ranks in this process, this
    process being rank 0: ``"fake"`` (torch's test backend, no traffic:
    meshes for the sharding rules) or ``"gloo"`` with world 1. Destroyed
    on exit, so the next test module starts without one."""
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore

        store = FakeStore()
    else:
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh(shape, names) -> DeviceMesh:
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=tuple(names))


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t):
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# tests/test_torch_distributed.py
# ---------------------------------------------------------------------------

def collectives_and_state(rank, world, ref_path, ckpt_dirs):
    """hierarchical_psum and int8_allreduce on 8 ranks; reshard; restore
    with shardings."""
    from repro_torch.core import elastic as el
    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.train.checkpoint import CheckpointManager

    ref = _load(ref_path)
    out = {"rank": rank}

    pod_data = mesh((2, 4), ("pod", "data"))
    x = _t(ref["psum_x"])
    with set_mesh(pod_data):
        flat = C.psum(x, ("pod", "data"))
        hier = C.hierarchical_psum(x)
    out["psum_flat"], out["psum_hier"] = _np(flat), _np(hier)

    data8 = mesh((8,), ("data",))
    vals = _t(ref["int8_vals"])
    with set_mesh(data8):
        red, err = C.int8_allreduce(vals[rank], axis="data", error=torch.zeros_like(vals[rank]))
        mean = C.pmean(vals[rank], "data")
    out["int8_out"], out["int8_err"], out["pmean"] = _np(red), _np(err), _np(mean)

    # reshard onto a one-rank mesh (the reference's current-devices case)
    # and from a (2, 4) layout onto an (8,) one
    one = mesh((8, 1), ("data", "model"))["model"]
    moved = el.reshard({"w": np.ones((4, 4), np.float32)}, one, lambda leaf: P())
    out["reshard_one"] = (type(moved["w"]).__name__, moved["w"].device_mesh.size(),
                          float(moved["w"].full_tensor().sum()))
    dm = mesh((2, 4), ("data", "model"))
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    src = el.reshard({"w": w}, dm, lambda leaf: P("data", "model"))
    dst = el.reshard(src, data8, lambda leaf: P(None, "data"))
    out["reshard_move"] = (tuple(src["w"].to_local().shape), tuple(dst["w"].to_local().shape),
                           bool(torch.equal(dst["w"].full_tensor(), w)),
                           bool(torch.equal(dst["w"].to_local(), w[:, rank:rank + 1])))

    # constrain: the identity on a plain tensor, a redistribution of a
    # DTensor to the spec's placements, never a change of value
    from repro_torch.distributed.sharding import constrain, distribute, logical_axis_rules

    xd = distribute(w, P("data", None), dm)
    with logical_axis_rules({"batch": "data", "d_model": "model"}, dm):
        kept = constrain(xd, "batch", None)
        moved = constrain(xd, None, "d_model")
        plain = constrain(w, None, "d_model")
    out["constrain"] = (kept is xd, tuple(moved.placements) == (Replicate(), Shard(1)),
                        bool(torch.equal(moved.full_tensor(), w)), plain is w)

    # restore a single-rank checkpoint onto a 2-rank Shard(0) layout
    pair = mesh((4, 2), ("data", "model"))["model"]
    r2 = pair.get_coordinate()[0]
    restored = {}
    for name, d in ckpt_dirs.items():  # det: ok key-addressed
        like = {"w": torch.zeros(6, 5), "b": torch.zeros(5)}
        shard = {"w": NamedSharding(pair, P("model", None)), "b": None}
        got = CheckpointManager(d).restore(like, shardings=shard)
        restored[name] = (type(got["w"]).__name__, int(r2), _np(got["w"].to_local()),
                          _np(got["w"].full_tensor()), _np(got["b"]))
    out["restore"] = restored
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_perf_paths.py
# ---------------------------------------------------------------------------

def _moe_blocks(p, rules, ep):
    """The rank's blocks of a MoE param tree (router and shared expert
    whole; experts or expert-FF sliced over "model")."""
    wi = sh.P("model", None, None) if ep else sh.P(None, None, "model")
    wo = sh.P("model", None, None) if ep else sh.P(None, "model", None)
    q = dict(p)
    for name, spec in (("wi", wi), ("wg", wi), ("wo", wo)):
        q[name] = sh.local_block(p[name], spec, rules.mesh).contiguous()
    return q


def perf_paths(rank, world, ref_path):
    """apply_moe_shard_map (EP, ff-TP, gradient) and the capacity-sharded
    decode on a (2, 4) data × model mesh of 8 ranks."""
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as T

    ref = _load(ref_path)
    dm = mesh((2, 4), ("data", "model"))
    out = {"rank": rank, "coord": tuple(dm.get_coordinate())}

    for case in ("ep", "fftp"):
        r = ref[case]
        cfg = ModelConfig(**r["cfg"])
        rules = sh.strategy_for(cfg, dm, moe_shard_map=True)
        p = _moe_blocks(params_from_reference(r["params"], "cpu"), rules, case == "ep")
        x = _t(r["x"])
        x_l = sh.local_block(x, rules.spec(("batch", None, None), x.shape), dm)
        with sh.logical_axis_rules(rules):
            y, aux = moe_lib.apply_moe(cfg, p, x_l)
        out[case] = {"y": _np(y), "aux": {k: float(v) for k, v in aux.items()},  # det: ok keyed
                     "ep": rules.rules["expert"], "moe_ff": rules.rules["moe_ff"]}

    # the EP call again on DTensors (weights by param_specs' layout, x by
    # the batch's): shard_map takes their blocks and returns DTensors
    r = ref["ep"]
    cfg = ModelConfig(**r["cfg"])
    rules = sh.strategy_for(cfg, dm, moe_shard_map=True)
    whole = params_from_reference(r["params"], "cpu")
    specs = sh.param_specs({"moe": whole}, rules)["moe"]
    pd = {k: sh.distribute(v, specs[k], dm) if k != "shared" else
          {n: sh.distribute(w, specs[k][n], dm) for n, w in v.items()}  # det: ok keyed
          for k, v in whole.items()}  # det: ok keyed
    x = _t(r["x"])
    xd = sh.distribute(x, rules.spec(("batch", None, None), x.shape), dm)
    with sh.logical_axis_rules(rules):
        y, aux = moe_lib.apply_moe_shard_map(cfg, pd, xd, rules)
    out["ep_dtensor"] = {"types": (type(y).__name__, type(aux["z_loss"]).__name__),
                         "wi_local": tuple(pd["wi"].to_local().shape),
                         "local": _np(y), "full": _np(y.full_tensor())}

    # gradient: each rank's is its data shard's; the sum over data is the
    # global batch's
    r = ref["grad"]
    cfg = ModelConfig(**r["cfg"])
    rules = sh.strategy_for(cfg, dm, moe_shard_map=True)
    p = _moe_blocks(params_from_reference(r["params"], "cpu"), rules, True)
    for v in p.values():
        v.requires_grad_(True)
    x = _t(r["x"])
    x_l = sh.local_block(x, rules.spec(("batch", None, None), x.shape), dm)
    with sh.logical_axis_rules(rules):
        y, aux = moe_lib.apply_moe_shard_map(cfg, p, x_l, rules)
    loss = (y.float() ** 2).sum() / x.numel() + 0.01 * aux["aux_loss"]
    loss.backward()
    grads = {}
    with set_mesh(dm):
        for name, v in sorted(p.items()):
            grads[name] = _np(C.psum(v.grad, "data"))
    out["grad"] = grads

    # capacity-sharded flash-decode: cache 32 over model = 4
    r = ref["decode"]
    cfg = get_config("qwen3-0.6b", smoke=True)
    params = params_from_reference(r["params"], "cpu")
    toks = _t(r["toks"])
    b, s = toks.shape
    rules = sh.strategy_for(cfg, dm, decode_flash_shard=True)
    rows = sh.block_range(rules.dim_rule("batch", b), b, dm)
    tl = toks[rows[0]:rows[1]]
    with sh.logical_axis_rules(rules):
        caches = T.init_caches(cfg, b, 32)
        _, caches = M.prefill(cfg, params, tl[:, : s - 1], caches)
        lg, _ = M.decode_step(cfg, params, tl[:, s - 1],
                              torch.full((tl.shape[0],), s - 1, dtype=torch.int32), caches)
    out["decode"] = {"rows": rows, "logits": _np(lg), "cache_cap": rules.rules["cache_cap"],
                     "local_k": tuple(caches["scan"][0]["k"].shape)}
    return out
