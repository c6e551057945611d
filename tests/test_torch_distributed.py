"""The port's distributed layer vs the JAX package's (tests/test_distributed.py).

The reference runs once, in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` as its own tests
run it, and pickles what it computed. The port's sharding rules are held
to it in this process, on meshes of torch's ``fake`` process group (eight
ranks, no traffic); its collectives, ``reshard`` and
``restore(shardings=)`` run once on 8 gloo CPU ranks (spawned, 120 s
timeout) for the whole module, and each test asserts on its part.

Rules: every config of ``configs/`` (smoke and full), on meshes (2, 4)
data × model, (2, 2, 2) pod × data × model and (8, 1), in modes ``tp``
(plain, with ``decode_flash_shard``, and with ``moe_shard_map``,
``decode_flash_shard`` and ``sequence_sharding`` together) and ``fsdp``
(with and without ``moe_shard_map``): every rule, note, option and spec of
``param_specs``, ``cache_specs`` and ``batch_specs`` must equal the
reference's. The port's FSDP budget is an H100's 80 GB, the reference's a
v5e's 16 GB; for this comparison ``force_fsdp`` is pinned to the
reference's decision and the port's ``HBM_BYTES`` to 16 GB, so the notes
name the same budget. The port's own decision is held separately.
"""

import hashlib
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import paper_pool
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.spawn import run_ranks
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.train.checkpoint import CheckpointManager

SRC = Path(__file__).resolve().parent.parent / "src"

MESHES = {
    "2x4": ((2, 4), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "8x1": ((8, 1), ("data", "model")),
}
MODES = {
    "tp": dict(mode="tp"),
    "tp+flash": dict(mode="tp", decode_flash_shard=True),
    "tp+all": dict(mode="tp", moe_shard_map=True, decode_flash_shard=True,
                   sequence_sharding=True),
    "fsdp": dict(mode="fsdp"),
    "fsdp+moe": dict(mode="fsdp", moe_shard_map=True),
}
CASES = [(a, smoke) for a in ARCHS for smoke in (True, False)]
BATCH, SEQ, CACHE = 8, 16, 64
ORDER_SPECS = [(("pod", "data"), None), (("data", "model", "pod"), None),
               ("model", ("pod", "data"))]

_REF = r"""
import dataclasses, json, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, get_config
from repro.distributed import sharding as sh
from repro.distributed.compat import shard_map
from repro.distributed.collectives import hierarchical_psum, int8_allreduce
from repro.models import model as M, transformer as T
from repro.train.checkpoint import CheckpointManager

MESHES, MODES, BATCH, SEQ, CACHE, ORDER_SPECS, out_path, ckpt_dir = pickle.loads(
    bytes.fromhex(sys.argv[1]))

def enc(spec):
    return [list(r) if isinstance(r, tuple) else r for r in spec]

def flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jax.tree_util.keystr(p): enc(s) for p, s in leaves}

out = {"rules": {}}
for arch in ARCHS:
    for smoke in (True, False):
        cfg = get_config(arch, smoke=smoke)
        params = jax.eval_shape(lambda: M.init(cfg, jax.random.PRNGKey(0)))
        caches = jax.eval_shape(lambda: T.init_caches(cfg, BATCH, CACHE))
        batch = {"tokens": jax.ShapeDtypeStruct((BATCH, SEQ), jnp.int32),
                 "labels": jax.ShapeDtypeStruct((BATCH, SEQ), jnp.int32),
                 "pos": jax.ShapeDtypeStruct((1,), jnp.int32)}
        for mname, (shape, names) in MESHES.items():
            mesh = jax.make_mesh(shape, names)
            tp = dict(zip(names, shape)).get("model", 1)
            pbytes = cfg.param_counts()["total"] * (2 if cfg.param_dtype == "bfloat16" else 4)
            fsdp = bool(pbytes / max(tp, 1) > sh.HBM_BYTES * sh.PARAM_BUDGET_FRACTION)
            for mode, kw in MODES.items():
                rules = sh.strategy_for(cfg, mesh, **kw)
                out["rules"][(arch, smoke, mname, mode)] = {
                    "fsdp": fsdp,
                    "rules": {k: list(v) if isinstance(v, tuple) else v
                              for k, v in rules.rules.items()},
                    "notes": rules.notes, "options": rules.options,
                    "params": flat(sh.param_specs(params, rules)),
                    "caches": flat(sh.cache_specs(caches, rules)),
                    "batch": flat(sh.batch_specs(batch, rules)),
                }

# the test_distributed.py cases
mesh = jax.make_mesh((2, 4), ("data", "model"))
r = sh.strategy_for(get_config("musicgen-medium", smoke=True), mesh)
out["musicgen"] = (r.rules["heads"], r.rules["d_ff"], r.notes)
r2 = sh.strategy_for(get_config("qwen3-0.6b", smoke=True), mesh)
out["batch1"] = enc(r2.spec(("batch", None), (1, 8)))

# block order of several mesh axes on one dimension (major first)
mesh3 = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
order = {}
for spec in ORDER_SPECS:
    idx = NamedSharding(mesh3, P(*spec)).devices_indices_map((8, 8))
    for coord in np.ndindex(2, 2, 2):
        sl = idx[mesh3.devices[coord]]
        order[(repr(spec), coord)] = [(s.start or 0, s.stop or 8) for s in sl]
out["order"] = order

# collectives
mesh = jax.make_mesh((2, 4), ("pod", "data"))
x = jnp.asarray(np.random.default_rng(0).normal(0, 1, (8, 33)), jnp.float32)
out["psum_x"] = np.asarray(x)
out["psum_hier"] = np.asarray(shard_map(lambda v: hierarchical_psum(v), mesh=mesh,
                                        in_specs=P(), out_specs=P(), check_vma=False)(x))
mesh8 = jax.make_mesh((8,), ("data",))
vals = jnp.asarray(np.random.default_rng(1).normal(0, 1, (8, 1000)), jnp.float32)
def comp(v, e):
    o, e2 = int8_allreduce(v[0], axis="data", error=e[0])
    return o[None], e2[None]
o, e = shard_map(comp, mesh=mesh8, in_specs=(P("data"), P("data")),
                 out_specs=(P("data"), P("data")), check_vma=False)(vals, jnp.zeros_like(vals))
out["int8_vals"], out["int8_out"], out["int8_err"] = (np.asarray(vals), np.asarray(o),
                                                      np.asarray(e))

# a checkpoint written by the reference
rng = np.random.default_rng(2)
tree = {"w": jnp.asarray(rng.normal(0, 1, (6, 5)), jnp.float32),
        "b": jnp.asarray(rng.normal(0, 1, (5,)), jnp.float32)}
CheckpointManager(ckpt_dir).save(3, tree)
out["ckpt_tree"] = {k: np.asarray(v) for k, v in tree.items()}
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


def _reference(tmp):
    ref_path, ckpt = tmp / "ref.pkl", tmp / "ckpt_ref"
    arg = pickle.dumps((MESHES, MODES, BATCH, SEQ, CACHE, ORDER_SPECS, str(ref_path), str(ckpt)))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF), arg.hex()],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(ref_path, "rb") as f:
        return pickle.load(f), ckpt


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's results, then the 8-rank run of the port."""
    tmp = tmp_path_factory.mktemp("dist")
    ref, ckpt_ref = _reference(tmp)
    ckpt_port = tmp / "ckpt_port"
    CheckpointManager(str(ckpt_port)).save(3, {k: torch.from_numpy(v) for k, v in
                                               ref["ckpt_tree"].items()})  # det: ok keyed
    ranks = run_ranks(R.collectives_and_state, 8,
                      (str(tmp / "ref.pkl"), {"port": str(ckpt_port), "reference": str(ckpt_ref)}),
                      timeout=120)
    return ref, ranks


@pytest.fixture(scope="module")
def fake_group():
    with R.process_group("fake", 8):
        yield


def _enc(spec):
    return [list(r) if isinstance(r, tuple) else r for r in spec]


def _flat(tree):
    """keystr → encoded spec, in the reference's naming."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}[{k!r}]")
        elif isinstance(t, sh.PartitionSpec):
            out[path] = _enc(t)
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")

    walk(tree, "")
    return out


def _trees(cfg):
    params = M.init(cfg, torch.Generator().manual_seed(0), "meta")
    caches = T.init_caches(cfg, BATCH, CACHE, device="meta")
    batch = {"tokens": torch.empty(BATCH, SEQ, dtype=torch.int32, device="meta"),
             "labels": torch.empty(BATCH, SEQ, dtype=torch.int32, device="meta"),
             "pos": torch.empty(1, dtype=torch.int32, device="meta")}
    return params, caches, batch


@pytest.mark.parametrize("arch,smoke", CASES, ids=[f"{a}-{'smoke' if s else 'full'}" for a, s in CASES])
def test_strategy_and_specs_equal_the_reference(run, fake_group, monkeypatch, arch, smoke):
    ref = run[0]["rules"]
    monkeypatch.setattr(sh, "HBM_BYTES", 16e9)  # the reference's per-chip budget
    cfg = get_config(arch, smoke=smoke)
    params, caches, batch = _trees(cfg)
    for mname, (shape, names) in MESHES.items():
        mesh = R.mesh(shape, names)
        for mode, kw in MODES.items():
            want = ref[(arch, smoke, mname, mode)]
            rules = sh.strategy_for(cfg, mesh, force_fsdp=want["fsdp"], **kw)
            got = {k: list(v) if isinstance(v, tuple) else v for k, v in rules.rules.items()}
            where = (mname, mode)
            assert got == want["rules"], where
            assert rules.notes == want["notes"], where
            assert rules.options == want["options"], where
            assert _flat(sh.param_specs(params, rules)) == want["params"], where
            assert _flat(sh.cache_specs(caches, rules)) == want["caches"], where
            assert _flat(sh.batch_specs(batch, rules)) == want["batch"], where


@pytest.mark.parametrize("arch", ARCHS)
def test_port_fsdp_decision_uses_the_h100_budget(fake_group, arch):
    """Unpinned, the port decides FSDP from an H100's 80 GB:
    master bytes / TP > 0.35 · 80e9."""
    cfg = get_config(arch)
    pbytes = cfg.param_counts()["total"] * (2 if cfg.param_dtype == "bfloat16" else 4)
    for shape, names in MESHES.values():
        rules = sh.strategy_for(cfg, R.mesh(shape, names))
        tp = dict(zip(names, shape))["model"] if "model" in names else 1
        assert sh.HBM_BYTES == 80e9
        assert ("FSDP:" in rules.notes) == (pbytes / tp > 0.35 * 80e9), (arch, shape)


def test_musicgen_and_batch1_fallbacks(run, fake_group):
    """tests/test_distributed.py: musicgen's 6 heads replicate over TP = 4
    while its d_ff shards; qwen3's heads shard; the embedding and wq
    specs; a batch of 1 cannot shard over data."""
    ref = run[0]
    mesh = R.mesh((2, 4), ("data", "model"))
    rules = sh.strategy_for(get_config("musicgen-medium", smoke=True), mesh)
    assert (rules.rules["heads"], rules.rules["d_ff"], rules.notes) == ref["musicgen"]
    assert rules.rules["heads"] is None and rules.rules["d_ff"] == "model"
    assert "not divisible" in rules.notes
    cfg2 = get_config("qwen3-0.6b", smoke=True)
    rules2 = sh.strategy_for(cfg2, mesh)
    assert rules2.rules["heads"] == "model"
    with sh.logical_axis_rules(rules2):
        specs = sh.param_specs(M.init(cfg2, torch.Generator().manual_seed(0), "meta"))
    assert specs["embed"]["embedding"] == sh.P("model", None)
    assert specs["scan"][0]["attn"]["wq"] == sh.P("layers", None, "model") or \
        specs["scan"][0]["attn"]["wq"] == sh.P(None, None, "model")
    spec1 = rules2.spec(("batch", None), (1, 8))
    assert spec1 == sh.P(None, None) and _enc(spec1) == ref["batch1"]


def test_block_order_major_axis_first(run, fake_group):
    """On a 2×2×2 mesh, a rank's block of a dimension sharded over several
    axes is the reference's, major axis first, for either order of the
    axes; DTensor placements exist only for the mesh's order."""
    ref = run[0]["order"]
    mesh = R.mesh((2, 2, 2), ("pod", "data", "model"))
    for spec in ORDER_SPECS:
        for coord in np.ndindex(2, 2, 2):
            c = dict(zip(("pod", "data", "model"), coord))
            got = [sh.block_range(rule, 8, mesh, c) if rule is not None else (0, 8)
                   for rule in spec]
            assert got == ref[(repr(spec), coord)], (spec, coord)
    assert sh.placements(sh.P(("pod", "data"), None), mesh)[:2] == (
        torch.distributed.tensor.Shard(0), torch.distributed.tensor.Shard(0))
    with pytest.raises(ValueError, match="mesh's order"):
        sh.placements(sh.P(("data", "model", "pod"), None), mesh)


def test_constrain_is_the_identity_on_plain_tensors(fake_group):
    x = torch.randn(4, 8)
    assert sh.constrain(x, "batch", None) is x
    mesh = R.mesh((2, 4), ("data", "model"))
    with sh.logical_axis_rules(sh.strategy_for(get_config("qwen3-0.6b", smoke=True), mesh)):
        assert sh.constrain(x, "batch", None) is x
        assert sh.resolve(("batch", None), (4, 8)) == sh.P("data", None)


def test_constrain_redistributes_dtensors_only(run):
    for r in run[1]:
        assert r["constrain"] == (True, True, True, True)


def test_hierarchical_psum_equals_flat(run):
    ref, ranks = run
    for r in ranks:
        assert np.abs(r["psum_flat"] - r["psum_hier"]).max() < 1e-4
        np.testing.assert_allclose(r["psum_hier"], ref["psum_hier"], rtol=0, atol=1e-4)


def test_int8_allreduce_matches_the_reference(run):
    ref, ranks = run
    out = np.stack([r["int8_out"] for r in ranks])
    err = np.stack([r["int8_err"] for r in ranks])
    mean = np.stack([r["pmean"] for r in ranks])
    np.testing.assert_allclose(out, ref["int8_out"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(err, ref["int8_err"], rtol=0, atol=1e-6)
    assert np.abs(out - mean).max() / np.abs(mean).max() < 0.02
    assert np.abs(err).max() > 0  # residual captured


def test_reshard_moves_a_tree(run):
    """tests/test_vdc_elastic.py::test_reshard_on_current_devices on a
    one-rank mesh, and a tree moved from a (2, 4) layout to an (8,) one."""
    for r in run[1]:
        assert r["reshard_one"] == ("DTensor", 1, 16.0)
        assert r["reshard_move"] == ((4, 2), (8, 1), True, True)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_restore_onto_a_sharded_layout(run, writer):
    """A single-rank checkpoint restores onto a 2-rank Shard(0) layout bit
    for bit; the reference's writes restore into the port."""
    ref, ranks = run
    w, b = ref["ckpt_tree"]["w"], ref["ckpt_tree"]["b"]
    for r in ranks:
        kind, coord, local, full, bias = r["restore"][writer]
        assert kind == "DTensor"
        assert np.array_equal(local, w[3 * coord:3 * coord + 3])
        assert np.array_equal(full, w) and np.array_equal(bias, b)


# ---------------------------------------------------------------------------
# F2: the package API of the reference
# ---------------------------------------------------------------------------

def test_core_exports_the_reference_names():
    import repro.core as ref_core
    import repro_torch.core as port_core
    from repro_torch.core import gpu_pool, schedule  # noqa: F401

    want = [("gpu_pool" if n == "tpu_pool" else n) for n in ref_core.__all__]
    assert port_core.__all__ == want
    for name in want:
        assert getattr(port_core, name) is not None, name
    assert port_core.simulator.__name__ == "repro_torch.core.simulator"


def test_models_exports_model_lib():
    import repro_torch.models as models

    assert models.model_lib is M
    assert "model_lib" in models.__all__


def test_streaming_pipeline_copy_equals_the_example():
    ex = (SRC.parent / "examples" / "streaming_pipeline.py").read_text().splitlines()
    port = (SRC / "repro_torch" / "streaming_pipeline.py").read_text().splitlines()
    assert len(ex) == len(port)
    diff = [(a, b) for a, b in zip(ex, port) if a != b]
    assert diff == [("from repro.data import (Fetch, HistoricFetch, MessageBroker, NeubotStream,",
                     "from repro_torch.data import (Fetch, HistoricFetch, MessageBroker, NeubotStream,")]


def test_streaming_pipeline_runs(capsys):
    from repro_torch import streaming_pipeline

    streaming_pipeline.main()
    assert "streaming pipeline OK" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# gpu_pool (ROADMAP item 12)
# ---------------------------------------------------------------------------

def test_gpu_pool_structure():
    from repro_torch.core import gpu_pool
    from repro_torch.core.cost_model import H100_NET_BW, H100_PCIE_BW

    pool = gpu_pool(nodes=2)
    gpus = [p for p in pool.pes if p.kind == "gpu"]
    assert [p.name for p in gpus] == [f"gpu_n{n}_g{g}" for n in (0, 1) for g in (1, 2, 4, 8)]
    assert [p.chips for p in gpus] == [1, 2, 4, 8] * 2
    assert all(p.speed == p.chips and p.power_busy == 700.0 * p.chips for p in gpus)
    hosts = [p for p in pool.pes if p.kind == "host_cpu"]
    assert len(hosts) == 8 and all(p.location == "frontend" for p in hosts)
    assert pool.link("frontend", "node0").bandwidth == H100_PCIE_BW
    assert pool.link("node0", "frontend").bandwidth == H100_PCIE_BW
    assert pool.link("node0", "node1").bandwidth == H100_NET_BW
    pool.validate()


def _learned_table():
    from repro_torch.core import LearnedCostModel
    from repro_torch.core.cost_model import rate_table_with
    from repro_torch.core.dag import Task

    lm = LearnedCostModel()
    backend = paper_pool().pe("v100_0")
    for fam_op, rate in (("ingest", 900.0), ("window_agg", 2500.0), ("kmeans", 4000.0)):
        for i in range(4):
            work = 1.0 + i
            lm.observe(Task(f"t{i}", fam_op, work=work), backend, work / rate)
    return rate_table_with(lm, "gpu", ["v100", "alveo", "xeon"])


def test_gpu_rates_come_from_the_learned_model():
    """Each family's "gpu" rate is LearnedCostModel's ridge fit
    Σ(work·t) / (Σ t² + λ) over the samples of the card's PEs."""
    table = _learned_table()
    for fam, rate in (("etl", 900.0), ("stream", 2500.0), ("ml", 4000.0)):
        works = [1.0 + i for i in range(4)]
        ts = [w / rate for w in works]
        fit = sum(w * t for w, t in zip(works, ts)) / (sum(t * t for t in ts) + 1e-9)
        assert table[fam]["gpu"] == fit
        assert table[fam]["xeon"] == 4.0  # the calibrated columns stay


def test_eft_schedule_over_gpu_pool_is_deterministic():
    from repro_torch.core import CostModel, gpu_pool, schedule
    from repro_torch.pipeline import workloads

    def once():
        s = schedule(workloads.ds_workload(), gpu_pool(), CostModel(rate=_learned_table()),
                     policy="eft")
        return repr([(a.task, a.pe, a.start, a.finish, a.energy) for a in s.assignments])

    a, b = once(), once()
    assert a == b
    assert "gpu_n0_g" in a
    # byte-stable across runs and machines: the pinned digest of the repr
    assert hashlib.sha256(a.encode()).hexdigest() == (
        "19f1626a51d07007337d6d8a3389e5932ef2e579329a3dc0e63784728489f199")
