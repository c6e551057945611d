"""The port's training layer against the JAX package's: ``tests/test_train.py``
case for case on the port, each optimizer's update against the reference's
``apply_updates`` (f32, rtol = atol = 1e-6), ``schedule`` and ``_q8`` bit
for bit, ``loss_fn`` and every gradient leaf against
``jax.value_and_grad(loss_fn)`` for four SMOKE configs (f32, 2e-4 relative
to each leaf's largest magnitude; metrics rtol = atol = 2e-4), a 5-step
AdamW trajectory from the reference's own state (1e-4), and checkpoints
that restore across the two packages leaf for leaf."""

import math
import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jax_configs
from repro.data.loader import LoaderConfig as RefLoaderConfig
from repro.data.loader import TokenBatchLoader as RefLoader
from repro.models import frontends as JF
from repro.models import model as JM
from repro.train import checkpoint as JC
from repro.train import optimizer as JO
from repro.train.train_step import build_train_step as ref_build_train_step
from repro.train.train_step import init_train_state as ref_init_train_state
from repro_torch import configs, quickstart
from repro_torch.convert import params_from_reference, train_state_from_reference
from repro_torch.data.loader import LoaderConfig, TokenBatchLoader
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import FailureEvent, FailureInjector, RecoveryPolicy
from repro_torch.train.optimizer import (OptConfig, _dq8, _q8, apply_updates,
                                         init_opt_state, schedule)
from repro_torch.train.train_step import (build_eval_step, build_train_step,
                                          init_train_state, loss_and_grads)
from repro_torch.train.tree import flatten_with_path, leaves
from repro_torch.train.trainer import Trainer, TrainerConfig

CFG = configs.get_config("qwen3-0.6b", smoke=True)
JCFG = jax_configs.get_config("qwen3-0.6b", smoke=True)
OPTIMIZERS = ["adamw", "adamw8bit", "adafactor", "sgdm"]
GRAD_TOL = 2e-4


def _batch(B=4, S=16, cfg=CFG):
    ld = TokenBatchLoader(LoaderConfig(batch_size=B, seq_len=S,
                                       vocab_size=cfg.vocab_size, n_docs=32))
    return {k: torch.as_tensor(v) for k, v in next(iter(ld)).items()}


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in flat]


def _assert_trees_close(got, want, rtol, atol, exact_ints=True):
    """``got`` (port) and ``want`` (reference) leaf for leaf, under the same
    key paths in the same order."""
    g, w = flatten_with_path(got), _jflat(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (key, a), (_, b) in zip(g, w, strict=True):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if exact_ints and not np.issubdtype(b.dtype, np.floating):
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=key)


@pytest.fixture(scope="module")
def ref_grads():
    """Reference params (nudged by seeded noise), a batch and the
    reference's loss and gradients on it."""
    jp = JM.init(JCFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    jp = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rng.normal(0, 0.02, x.shape), x.dtype), jp)
    batch = _batch()
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(JCFG, p, jb), has_aux=True))(jp)
    return jp, grads, batch, float(loss)


# -- optimizers ------------------------------------------------------------------

@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_step_decreases_loss(name, ref_grads):
    jp, jg, batch, loss0 = ref_grads
    params, grads = params_from_reference(jp, "cpu"), params_from_reference(jg, "cpu")
    oc = OptConfig(name=name, lr=1e-3, warmup_steps=1, total_steps=10)
    p2, _, stats = apply_updates(params, grads, init_opt_state(params, oc), oc)
    loss1, _ = M.loss_fn(CFG, p2, batch)
    assert float(loss1) < loss0
    assert float(stats["grad_norm"]) > 0


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_updates_match_reference(name, clip, ref_grads):
    """Three updates from the same state, the gradient scaled ×1, ×0.5,
    ×2 per step: params and every state leaf equal the reference's (f32,
    1e-6; int8 blocks and steps exact)."""
    jp, jg, _, _ = ref_grads
    oc = OptConfig(name=name, lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=clip)
    joc = JO.OptConfig(name=name, lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=clip)
    jst, tst = JO.init_opt_state(jp, joc), init_opt_state(params_from_reference(jp, "cpu"), oc)
    _assert_trees_close(tst, jst, 0, 0)
    tp = params_from_reference(jp, "cpu")
    jupd = jax.jit(lambda p, g, s: JO.apply_updates(p, g, s, joc))
    for f in (1.0, 0.5, 2.0):
        g = jax.tree_util.tree_map(lambda x, f=f: x * f, jg)
        jp, jst, jstats = jupd(jp, g, jst)
        tp, tst, tstats = apply_updates(tp, params_from_reference(g, "cpu"), tst, oc)
        _assert_trees_close(tp, jp, 1e-6, 1e-6)
        _assert_trees_close(tst, jst, 1e-6, 1e-6, exact_ints=name != "adamw8bit")
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=1e-6)
    if name == "adamw8bit":  # int8 moments: off by at most one step of a block
        for (key, a), (_, b) in zip(flatten_with_path(tst), _jflat(jst), strict=True):
            if b.dtype == np.int8:
                assert np.abs(a.numpy().astype(int) - b.astype(int)).max() <= 1, key


def test_lr_schedule_shape():
    oc = OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    lrs = [float(schedule(oc, torch.tensor(s))) for s in (0, 5, 10, 55, 100, 200)]
    assert lrs[1] == pytest.approx(0.5, rel=1e-3)       # mid-warmup
    assert lrs[2] == pytest.approx(1.0, rel=1e-3)       # warmup done
    assert lrs[2] > lrs[3] > lrs[4]                     # cosine decay
    assert lrs[4] == pytest.approx(0.1, rel=1e-2)       # floor


@pytest.mark.parametrize("kw", [dict(lr=1.0, warmup_steps=10, total_steps=100),
                                dict(lr=3e-4, warmup_steps=100, total_steps=10000),
                                dict(lr=1e-3, warmup_steps=0, total_steps=1, min_lr_frac=0.0),
                                dict(lr=1e-3, warmup_steps=2, total_steps=20)])
def test_schedule_bit_equal_to_reference(kw):
    steps = np.arange(0, 400, dtype=np.int32)
    for s in steps:
        want = np.asarray(JO.schedule(JO.OptConfig(**kw), jnp.asarray(s)))
        got = schedule(OptConfig(**kw), torch.tensor(s)).numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), s


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 2000])
def test_q8_bit_equal_to_reference(n):
    """Values, scales and the dequantised moments bit for bit, on random
    data and on exact half-steps of a block's scale (ties to even)."""
    rng = np.random.default_rng(n)
    cases = [rng.normal(0, s, n).astype(np.float32) for s in (1e-6, 1.0, 1e3)]
    half = (rng.integers(-254, 255, n) / 2.0).astype(np.float32)
    half[::256] = 127.0                                 # each block's absmax
    cases.append(half)
    for x in cases:
        jq, js = JO._q8(jnp.asarray(x))
        q, s = _q8(torch.from_numpy(x))
        assert q.numpy().tobytes() == np.asarray(jq).tobytes()
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        back = _dq8(q, s, (n,)).numpy()
        assert back.tobytes() == np.asarray(JO._dq8(jq, js, (n,))).tobytes()


@pytest.mark.parametrize("n,scale", [(1, 1e-6), (300, 1.0), (2000, 1e3)])
def test_int8_block_quantization_bound(n, scale):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(0, scale, n).astype(np.float32))
    q, s = _q8(x)
    back = _dq8(q, s, (n,))
    # per-block absmax scaling → error ≤ scale/2 per block
    err = np.abs(back.numpy() - x.numpy())
    bound = np.repeat(s.numpy()[:, 0] / 2 + 1e-9, 256)[:n]
    assert (err <= bound + 1e-6).all()


# -- train step -------------------------------------------------------------------

def _state(seed=0, name="adamw"):
    oc = OptConfig(name=name, lr=1e-3, warmup_steps=1, total_steps=10)
    return oc, init_train_state(CFG, oc, torch.Generator().manual_seed(seed), "cpu")


def test_grad_accum_equivalence():
    oc, st = _state()
    batch = _batch(B=4)
    s1, _ = build_train_step(CFG, oc, remat=False, grad_accum=1)(st, batch)
    s2, m2 = build_train_step(CFG, oc, remat=False, grad_accum=2)(st, batch)
    d = [float((a - b).abs().max()) for a, b in zip(leaves(s1["params"]), leaves(s2["params"]), strict=True)]
    assert max(d) < 1e-4
    assert int(s2["step"]) == 1 and set(m2) >= {"loss", "ce", "lr", "grad_norm"}


def test_grad_accum_matches_reference():
    """Microbatch grads summed in f32 and divided, as the reference's scan:
    the accumulated step equals the reference's. SGD-momentum's update is
    linear in the gradient (Adam's first step is its sign), so the params
    hold the gradients' agreement: rtol 1e-5, atol 1e-6."""
    joc = JO.OptConfig(name="sgdm", lr=1e-3, warmup_steps=1, total_steps=10)
    jst = ref_init_train_state(JCFG, joc, jax.random.PRNGKey(0))
    batch = _batch(B=4)
    js2, jm = jax.jit(ref_build_train_step(JCFG, joc, remat=False, grad_accum=2))(
        jst, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    ts2, tm = build_train_step(CFG, OptConfig(name="sgdm", lr=1e-3, warmup_steps=1, total_steps=10),
                               remat=False, grad_accum=2)(train_state_from_reference(jst, "cpu"), batch)
    _assert_trees_close(ts2, js2, 1e-5, 1e-6)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)


def test_eval_step_matches_train_metrics():
    oc, st = _state()
    batch = _batch()
    m = build_eval_step(CFG)(st["params"], batch)
    _, tm = build_train_step(CFG, oc, remat=False)(st, batch)
    assert float(m["loss"]) == pytest.approx(float(tm["loss"]), rel=1e-6)


# -- loss_fn and gradients against jax.value_and_grad --------------------------------

LOSS_ARCHS = ["qwen3-0.6b", "gemma2-9b", "jamba-v0.1-52b", "llama-3.2-vision-11b"]
VARIANTS = {"plain": {}, "remat": {"remat": True}, "loss_chunk": {"loss_chunk": 8},
            "remat+loss_chunk": {"remat": True, "loss_chunk": 8}}


@pytest.fixture(scope="module", params=LOSS_ARCHS)
def loss_run(request):
    """One arch: converted params, a loader batch (+ the patch stub for
    the VLM) and the reference's loss, metrics and gradients, jitted once."""
    arch = request.param
    cfg, jcfg = configs.get_config(arch, smoke=True), jax_configs.get_config(arch, smoke=True)
    jp = JM.init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    jp = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rng.normal(0, 0.02, x.shape), x.dtype), jp)
    batch = {k: v.numpy() for k, v in _batch(B=2, S=16, cfg=cfg).items()}
    if cfg.family == "vlm":
        batch["vision"] = JF.fake_patch_embeddings(jcfg, 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb), has_aux=True))(jp)
    return {"cfg": cfg, "tp": params_from_reference(jp, "cpu"),
            "batch": {k: torch.as_tensor(v) for k, v in batch.items()},
            "loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _jflat(grads)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_grads_match_reference(loss_run, variant):
    """Metrics (rtol = atol = 2e-4; token count and drop fraction exact)
    and every gradient leaf within 2e-4 of the leaf's largest magnitude.
    ``remat`` and ``loss_chunk`` change what is recomputed, not the
    function, so each variant is held to the reference's plain gradient."""
    grads, metrics = loss_and_grads(loss_run["cfg"], loss_run["tp"], loss_run["batch"],
                                    **VARIANTS[variant])
    want = loss_run["metrics"]
    assert set(metrics) == set(want)
    for k in ("ce", "loss", "aux_loss", "z_loss"):
        np.testing.assert_allclose(float(metrics[k]), want[k], rtol=2e-4, atol=2e-4, err_msg=k)
    assert float(metrics["tokens"]) == want["tokens"]
    assert float(metrics["dropped_frac"]) == want["dropped_frac"]
    got = flatten_with_path(grads)
    assert [k for k, _ in got] == [k for k, _ in loss_run["grads"]]
    for (key, g), (_, w) in zip(got, loss_run["grads"], strict=True):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, key
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err <= GRAD_TOL, (key, err)
    if loss_run["cfg"].n_experts:
        assert want["aux_loss"] > 0 and want["z_loss"] > 0


def test_adamw_trajectory_matches_reference():
    """Five AdamW steps from the reference's own initial state, carried
    across by ``train_state_from_reference``, on the same loader batches:
    the losses and the final params within 1e-4."""
    joc = JO.OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    oc = OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    jst = ref_init_train_state(JCFG, joc, jax.random.PRNGKey(0))
    st = train_state_from_reference(jst, "cpu")
    jstep = jax.jit(ref_build_train_step(JCFG, joc, remat=False))
    step = build_train_step(CFG, oc, remat=False)
    ref_ld = RefLoader(RefLoaderConfig(batch_size=4, seq_len=32, vocab_size=CFG.vocab_size, n_docs=64))
    ld = TokenBatchLoader(LoaderConfig(batch_size=4, seq_len=32, vocab_size=CFG.vocab_size, n_docs=64))
    jl, tl = [], []
    for _ in range(5):
        rb, b = next(ref_ld), next(ld)
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in rb.items()})
        st, m = step(st, b)
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    assert tl[-1] < tl[0]
    _assert_trees_close(st, jst, 1e-4, 1e-4)


# -- attention and scan under autograd ------------------------------------------------

@pytest.mark.parametrize("hq,hkv,d,window,softcap", [(16, 8, 128, 0, 0.0),
                                                     (4, 2, 64, 5, 50.0),
                                                     (4, 4, 72, 0, 0.0)])
def test_flash_function_gradient_is_chunked_attention_gradient(monkeypatch, hq, hkv, d, window, softcap):
    """``FlashAttentionFn`` with its launch stood in by the plain version
    (the CPU has no kernel): forward equals the launch, and the gradient
    of q, k and v equals autograd through ``chunked_attention`` (f32,
    2e-4), windows and softcap included."""
    monkeypatch.setattr(flash_ops, "_launch", lambda q, k, v, causal, window, softcap, scale: (
        flash_ops.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                      causal=causal, window=window, softcap=softcap,
                                      scale=scale).transpose(1, 2)))
    g = torch.Generator().manual_seed(d)
    q = torch.randn((2, 19, hq, d), generator=g, requires_grad=True)
    k = torch.randn((2, 19, hkv, d), generator=g, requires_grad=True)
    v = torch.randn((2, 19, hkv, d), generator=g, requires_grad=True)
    w = torch.randn((2, 19, hq, d), generator=g)
    scale = 1.0 / math.sqrt(d)
    out = flash_ops.FlashAttentionFn.apply(q, k, v, True, window, softcap, scale)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    pos = torch.arange(19, dtype=torch.int32)[None].expand(2, 19)
    ref = L.chunked_attention(q, k, v, q_positions=pos, kv_positions=pos, window=window,
                              softcap=softcap, chunk=8)
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-4)
    want = torch.autograd.grad((ref * w).sum(), (q, k, v))
    for a, b in zip(got, want, strict=True):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


def test_chunked_attention_checkpoint_keeps_values_and_grads():
    """The per-chunk checkpoint (taken when autograd records) changes
    neither the output nor the gradient: bit-equal to the same chunks run
    without it, under ``torch.no_grad`` for the output."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 33, 4, 16), generator=g) for _ in range(3))
    pos = torch.arange(33, dtype=torch.int32)[None].expand(2, 33)
    kw = dict(q_positions=pos, kv_positions=pos, chunk=8, window=11, softcap=20.0)
    with torch.no_grad():
        plain = L.chunked_attention(q, k, v, **kw)
    leaves_ = [t.clone().requires_grad_() for t in (q, k, v)]
    out = L.chunked_attention(*leaves_, **kw)
    assert torch.equal(out, plain) and out.grad_fn is not None
    grads = torch.autograd.grad(out.square().sum(), leaves_)
    assert all(torch.isfinite(t).all() for t in grads)


@pytest.mark.parametrize("chunk", [1, 2, 7, 16, 33])
def test_scan_out_of_place_equals_in_place(chunk):
    """Under autograd the doubling scan builds new tensors: bit-equal to
    the in-place serving form, inputs untouched, and differentiable."""
    rng = np.random.default_rng(chunk)
    da = torch.from_numpy(rng.uniform(0.5, 1.0, (2, chunk, 6, 4)).astype(np.float32))
    dbu = torch.from_numpy(rng.normal(0, 1, (2, chunk, 6, 4)).astype(np.float32))
    h0 = torch.from_numpy(rng.normal(0, 1, (2, 6, 4)).astype(np.float32))
    h_in, last_in = ssm._scan_chunk(da.clone(), dbu.clone(), h0)
    a, b = da.clone().requires_grad_(), dbu.clone().requires_grad_()
    h_out, last_out = ssm._scan_chunk(a, b, h0)
    assert torch.equal(h_out, h_in) and torch.equal(last_out, last_in)
    assert torch.equal(a, da) and torch.equal(b, dbu)
    ga, gb = torch.autograd.grad(h_out.sum(), (a, b))
    assert torch.isfinite(ga).all() and torch.isfinite(gb).all()


def test_cpu_attention_is_differentiable():
    """On the CPU ``flash_attention`` is the plain version: its output has a
    ``grad_fn``, and no kernel is counted."""
    before = flash_ops.flash_attention.launches
    q = torch.randn((1, 5, 2, 8), requires_grad=True)
    out = flash_ops.flash_attention(q, q.detach(), q.detach())
    assert out.grad_fn is not None and flash_ops.flash_attention.launches == before


# -- checkpointing -----------------------------------------------------------------

def test_checkpoint_roundtrip_and_gc():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "b": {"c": torch.tensor(3, dtype=torch.int32)},
                "h": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)}
        for step in (1, 2, 3):
            mgr.save(step, tree)
        assert mgr.all_steps() == [2, 3]                 # gc keeps 2
        out = mgr.restore(tree, step=3)
        assert torch.equal(out["a"], tree["a"]) and torch.equal(out["h"], tree["h"])
        assert out["h"].dtype == torch.bfloat16
        assert int(out["b"]["c"]) == 3


def test_checkpoint_torn_write_ignored():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        tree = {"a": torch.ones((2,))}
        mgr.save(5, tree)
        # simulate a worker dying mid-save: directory without COMMITTED
        os.makedirs(os.path.join(d, "step_00000009"))
        assert mgr.latest_step() == 5
        # and a stale tmp dir
        os.makedirs(os.path.join(d, "step_00000011.tmp"))
        assert mgr.latest_step() == 5


def test_checkpoint_structure_mismatch_rejected():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, {"a": torch.ones((2,))})
        with pytest.raises(ValueError):
            mgr.restore({"a": torch.ones((2,)), "b": torch.ones((1,))})
        with pytest.raises(ValueError):
            mgr.restore({"z": torch.ones((2,))})


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_checkpoints_interchange_with_reference(name):
    """A train state saved by the reference's ``CheckpointManager`` is
    restored by the port's, and the port's by the reference's: the same
    manifest keys, leaf for leaf, bit for bit."""
    joc = JO.OptConfig(name=name, lr=1e-3, warmup_steps=1, total_steps=10)
    jst = ref_init_train_state(JCFG, joc, jax.random.PRNGKey(0))
    jst = jax.tree_util.tree_map(lambda x: x + 1 if x.dtype == jnp.int32 else x, jst)
    with tempfile.TemporaryDirectory() as d:
        JC.CheckpointManager(os.path.join(d, "ref")).save(7, jst)
        like = train_state_from_reference(jax.tree_util.tree_map(jnp.zeros_like, jst), "cpu")
        got = CheckpointManager(os.path.join(d, "ref")).restore(like)
        _assert_trees_close(got, jst, 0, 0)
        port = CheckpointManager(os.path.join(d, "port"))
        port.save(7, train_state_from_reference(jst, "cpu"))
        back = JC.CheckpointManager(os.path.join(d, "port")).restore(
            jax.tree_util.tree_map(jnp.zeros_like, jst))
        _assert_trees_close(got, back, 0, 0)
        with open(os.path.join(d, "ref", "step_00000007", "MANIFEST.json")) as f:
            ref_manifest = f.read()
        with open(os.path.join(d, "port", "step_00000007", "MANIFEST.json")) as f:
            assert f.read() == ref_manifest


# -- fault tolerance -----------------------------------------------------------------

def _data():
    while True:
        ld = TokenBatchLoader(LoaderConfig(batch_size=4, seq_len=16,
                                           vocab_size=CFG.vocab_size,
                                           n_docs=64))
        yield from ld


def test_trainer_restarts_from_checkpoint_on_failure():
    with tempfile.TemporaryDirectory() as d:
        inj = FailureInjector([FailureEvent(step=7, worker="w1", kind="die")])
        tr = Trainer(CFG, OptConfig(lr=1e-3, warmup_steps=2, total_steps=30),
                     TrainerConfig(n_steps=12, ckpt_every=5, ckpt_dir=d,
                                   log_every=100, n_workers=4),
                     _data(), injector=inj, device="cpu")
        out = tr.train()
        assert out["restarts"] == 1
        acts = out["recovery_log"]
        assert acts[0].action == "restart_from_checkpoint"
        assert acts[0].restored_step == 5
        assert acts[0].plan.mesh_shape == {"data": 3, "model": 1}
        # training completed to target despite the replay
        assert out["history"][-1]["step"] == 12
        assert [h["step"] for h in out["history"]] == list(range(1, 8)) + list(range(6, 13))
        assert out["history"][-1]["loss"] < out["history"][0]["loss"]
        assert CheckpointManager(d).all_steps() == [5, 10, 12]


def test_trainer_replay_repeats_the_restored_steps():
    """After the restart the replayed steps start from the restored state:
    step 6's params and loss equal the first run's step 6 on the same
    batch (the loader is rewound with it)."""
    batches = [b for _, b in zip(range(12), _data(), strict=False)]
    with tempfile.TemporaryDirectory() as d:
        inj = FailureInjector([FailureEvent(step=7, worker="w1", kind="die")])
        data = iter(batches[:7] + batches[5:])
        tr = Trainer(CFG, OptConfig(lr=1e-3, warmup_steps=2, total_steps=30),
                     TrainerConfig(n_steps=12, ckpt_every=5, ckpt_dir=d, log_every=100),
                     data, injector=inj, device="cpu")
        h = tr.train()["history"]
    assert h[7]["step"] == 6 and h[7]["loss"] == h[5]["loss"]


def test_recovery_policy_straggler_exclusion():
    pol = RecoveryPolicy(["w0", "w1", "w2", "w3"], devices_per_worker=2,
                         model_axis=2)
    act = None
    for step in range(5):
        act = pol.check_stragglers(
            step, {"w0": 1.0, "w1": 1.0, "w2": 1.0, "w3": 4.0},
            now=float(step), current_data_axis=4)
        if act:
            break
    assert act is not None and act.action == "exclude_straggler"
    assert act.plan.mesh_shape == {"data": 3, "model": 2}
    # rejoin grows back
    grow = pol.handle(10, FailureEvent(10, "w3", "rejoin"), 3)
    assert grow.plan.mesh_shape == {"data": 4, "model": 2}


# -- entry points ----------------------------------------------------------------------

def test_launch_train_cpu_smoke(tmp_path):
    """``python -m repro_torch.launch.train --cpu --smoke --steps 20`` exits 0
    (the loss falls), with a failure injected and a checkpoint restored."""
    rc = launch_train.main(["--cpu", "--smoke", "--steps", "20", "--ckpt-dir", str(tmp_path),
                            "--ckpt-every", "5", "--inject-failure-at", "12"])
    assert rc == 0
    assert CheckpointManager(str(tmp_path)).latest_step() == 20


def test_quickstart_step4_trains_on_cpu():
    losses = quickstart.train_lm_steps("cpu")
    assert len(losses) == 10 and losses[-1] < losses[0]


def test_entry_points_take_the_card_by_default():
    """Without ``device``/``--cpu`` the trainer asks for the card and raises
    when there is none: it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(CFG, OptConfig(), TrainerConfig(), _data())
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--smoke", "--steps", "1"])
