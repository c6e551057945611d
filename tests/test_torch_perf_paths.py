"""The port's shard-local paths vs the JAX package's (tests/test_perf_paths.py).

The reference runs once, in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``: its
``apply_moe_shard_map`` on a (2, 4) data × model mesh (EP: 4 experts over
TP = 4; ff-TP: 2 experts, the expert FF over TP), ``apply_moe_spmd``'s
output and gradient, and the single-device ``M.prefill`` +
``M.decode_step`` of qwen3-0.6b SMOKE. The reference's own sharded decode
test fails on a host-platform mesh (ROADMAP.md, queue 3), so the port's
capacity-sharded decode is held to the single-device reference. The port runs once on 8 gloo CPU ranks
(spawned, 120 s timeout), with the reference's weights carried across;
each test asserts on its part.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import torch_dist_ranks as R
from repro_torch.distributed.spawn import run_ranks

SRC = Path(__file__).resolve().parent.parent / "src"

_REF = r"""
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.distributed import sharding as sh
from repro.distributed.compat import set_mesh
from repro.models.config import ModelConfig
from repro.models import model as M, moe as moe_lib, transformer as T

out_path = sys.argv[1]
tree_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
out = {}
mesh = jax.make_mesh((2, 4), ("data", "model"))

cfg = ModelConfig(name="m", family="moe", n_layers=2, d_model=32,
                  n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=128,
                  n_experts=4, n_experts_per_tok=2, moe_period=1,
                  moe_offset=0, capacity_factor=8.0,
                  n_shared_experts=1, moe_d_ff=64, dtype="float32")
x = jnp.asarray(np.random.default_rng(0).normal(0, 1, (4, 16, 32)), jnp.float32)
cfg2 = dataclasses.replace(cfg, n_experts=2, moe_d_ff=64, n_shared_experts=0)
for name, c, key in (("ep", cfg, 0), ("fftp", cfg2, 1)):
    p = moe_lib.init_moe(c, jax.random.PRNGKey(key))
    y_spmd, aux_spmd = moe_lib.apply_moe_spmd(c, p, x)
    rules = sh.strategy_for(c, mesh, moe_shard_map=True)
    with sh.logical_axis_rules(rules):
        with set_mesh(mesh):
            y, aux = jax.jit(lambda p_, x_: moe_lib.apply_moe_shard_map(c, p_, x_, rules))(p, x)
    out[name] = {"cfg": dataclasses.asdict(c), "params": tree_np(p), "x": np.asarray(x),
                 "y": np.asarray(y), "aux": {k: float(v) for k, v in aux.items()},
                 "y_spmd": np.asarray(y_spmd),
                 "aux_spmd": {k: float(v) for k, v in aux_spmd.items()}}

cfg3 = ModelConfig(name="m", family="moe", n_layers=2, d_model=32,
                   n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=128,
                   n_experts=4, n_experts_per_tok=2, moe_period=1,
                   moe_offset=0, capacity_factor=8.0, dtype="float32")
p3 = moe_lib.init_moe(cfg3, jax.random.PRNGKey(0))
def loss_ref(p_):
    y, aux = moe_lib.apply_moe_spmd(cfg3, p_, x)
    return (y ** 2).mean() + 0.01 * aux["aux_loss"]
out["grad"] = {"cfg": dataclasses.asdict(cfg3), "params": tree_np(p3), "x": np.asarray(x),
               "g": tree_np(jax.grad(loss_ref)(p3))}

qcfg = get_config("qwen3-0.6b", smoke=True)
params = M.init(qcfg, jax.random.PRNGKey(0))
B, S = 8, 24
toks = jax.random.randint(jax.random.PRNGKey(1), (B, S), 2, qcfg.vocab_size)
caches = T.init_caches(qcfg, B, 32)
_, caches = M.prefill(qcfg, params, toks[:, :S-1], caches)
lg, _ = M.decode_step(qcfg, params, toks[:, S-1], jnp.full((B,), S-1, jnp.int32), caches)
out["decode"] = {"params": tree_np(params), "toks": np.asarray(toks), "logits": np.asarray(lg)}
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("perf_paths")
    ref_path = tmp / "ref.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF), str(ref_path)],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    ranks = run_ranks(R.perf_paths, 8, (str(ref_path),), timeout=120)
    return ref, ranks


def _assemble(ranks, part, b):
    """The global (B, ...) output from the ranks' data-shard blocks (every
    model rank of a data shard must hold the same block)."""
    rows = {}
    for r in ranks:
        d = r["coord"][0]
        blk = r[part]["y"]
        if d in rows:
            assert np.array_equal(rows[d], blk)
        rows[d] = blk
    out = np.concatenate([rows[d] for d in sorted(rows)])
    assert out.shape[0] == b
    return out


@pytest.mark.parametrize("case", ["ep", "fftp"])
def test_moe_shard_map_matches_the_reference(run, case):
    """EP (4 experts over TP = 4) and the ff-TP fallback (2 experts < TP):
    the output within 1e-4 of the reference's shard_map and its spmd
    formulation, z_loss within 1e-4, the other aux terms alike."""
    ref, ranks = run
    r = ref[case]
    y = _assemble(ranks, case, r["x"].shape[0])
    assert np.abs(y - r["y"]).max() < 1e-4
    assert np.abs(y - r["y_spmd"]).max() < 1e-4
    for rk in ranks:
        assert (rk[case]["ep"], rk[case]["moe_ff"]) == (("model", None) if case == "ep"
                                                          else (None, "model"))
        aux = rk[case]["aux"]
        assert abs(aux["z_loss"] - r["aux"]["z_loss"]) < 1e-4
        assert abs(aux["aux_loss"] - r["aux"]["aux_loss"]) < 1e-4
        assert abs(aux["dropped_frac"] - r["aux"]["dropped_frac"]) < 1e-6


def test_moe_shard_map_takes_dtensors(run):
    """DTensor weights (param_specs' layout: 1 of 4 experts a rank) and a
    DTensor batch go through shard_map's local blocks: the output and aux
    come back as DTensors, whose blocks equal the plain call's and whose
    whole output equals the reference's within 1e-4."""
    ref, ranks = run
    for rk in ranks:
        d = rk["ep_dtensor"]
        assert d["types"] == ("DTensor", "DTensor")
        assert d["wi_local"][0] == 1
        assert np.array_equal(d["local"], rk["ep"]["y"])
        assert np.abs(d["full"] - ref["ep"]["y"]).max() < 1e-4


def test_moe_shard_map_grad_matches_spmd(run):
    """The gradient of (y²).mean() + 0.01·aux_loss: each rank's weight
    gradients, summed over the data axis, within 1e-3 of
    ``apply_moe_spmd``'s (the reference's bound, f32 reduction order)."""
    ref, ranks = run
    g = ref["grad"]["g"]
    for rk in ranks:
        m = rk["coord"][1]
        got = rk["grad"]
        assert np.abs(got["router"] - g["router"]).max() < 1e-3
        for name in ("wi", "wg", "wo"):
            assert np.abs(got[name] - g[name][m:m + 1]).max() < 1e-3, name


def test_sharded_flash_decode_matches_single_device(run):
    """qwen3-0.6b SMOKE, B 8, S 24, cache 32 sharded over model = 4: each
    rank holds 8 slots, and the decode logits of its rows are within 2e-3
    of the single-device reference's."""
    ref, ranks = run
    lg = ref["decode"]["logits"]
    for rk in ranks:
        d = rk["decode"]
        assert d["cache_cap"] == "model"
        assert d["local_k"][1:3] == (4, 8)  # (layers, B/2 rows, C/4 slots, ...)
        lo, hi = d["rows"]
        assert np.abs(d["logits"] - lg[lo:hi]).max() < 2e-3


def test_moe_shard_map_on_one_rank_equals_spmd():
    """On a world-1 group apply_moe dispatches to the shard-local path
    (every expert on the one rank) and equals apply_moe_spmd."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("mixtral-8x22b", smoke=True), dtype="float32")
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(1))
    with R.process_group("gloo", 1):
        rules = sh.strategy_for(cfg, R.mesh((1, 1), ("data", "model")), moe_shard_map=True)
        with sh.logical_axis_rules(rules):
            y, aux = moe.apply_moe(cfg, p, x)
    y0, aux0 = moe.apply_moe_spmd(cfg, p, x)
    torch.testing.assert_close(y, y0, rtol=2e-4, atol=2e-4)
    for k in aux0:
        torch.testing.assert_close(aux[k], aux0[k], rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_block_writes_equal_the_whole_ring(n):
    """``update_cache(..., shard=(start, C))`` on n blocks of a ring of C
    slots writes, slot for slot, what the whole cache holds: rows at
    different depths, a segment, one longer than the ring, and one-token
    writes that wrap it."""
    import torch

    from repro_torch.models.kvcache import update_cache

    c, b, h, d = 8, 3, 2, 4

    def cache(cap):
        return {"k": torch.zeros(b, cap, h, d), "v": torch.zeros(b, cap, h, d),
                "pos": torch.full((b, cap), -1, dtype=torch.int32),
                "idx": torch.tensor([0, 3, 6], dtype=torch.int32)}

    whole = cache(c)
    blocks = [cache(c // n) for _ in range(n)]
    g = torch.Generator().manual_seed(0)
    for s in (5, 11, 1, 1, 1, 1, 1, 1):
        k, v = torch.randn(b, s, h, d, generator=g), torch.randn(b, s, h, d, generator=g)
        pos = whole["idx"][:, None] + torch.arange(s, dtype=torch.int32)
        update_cache(whole, k, v, pos)
        for r, blk in enumerate(blocks):
            update_cache(blk, k, v, pos, shard=(r * c // n, c))
        for name in ("k", "v", "pos"):
            assert torch.equal(torch.cat([blk[name] for blk in blocks], dim=1), whole[name])
        assert all(torch.equal(blk["idx"], whole["idx"]) for blk in blocks)
