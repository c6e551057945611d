"""The port's model substrate vs the JAX package: configs field for field,
each layer, the KV cache, and forward / prefill / decode / greedy
generation on converted parameters (f32, 2e-4; tokens exact)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jax_configs
from repro.models import kvcache as JK
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import kvcache as K
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

TOL = dict(rtol=2e-4, atol=2e-4)


def tiny(name="t", **kw):
    base = dict(
        name=name,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        dtype="float32",
    )
    base.update(kw)
    return ModelConfig(**base)


def _jax_cfg(cfg):
    """The JAX package's ModelConfig with the same fields."""
    from repro.models.config import ModelConfig as JaxModelConfig

    return JaxModelConfig(**dataclasses.asdict(cfg))


def _params(cfg, seed=0, noise=0.05):
    """JAX ``init`` parameters, every leaf nudged by seeded noise (so norm
    scales and biases are not all ones and zeros), in both packages."""
    jp = JM.init(_jax_cfg(cfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rng.normal(0, noise, x.shape), x.dtype), jp
    )
    return jp, params_from_reference(jp, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), **(tol or TOL))


# -- configs -----------------------------------------------------------------


@pytest.mark.parametrize("arch", jax_configs.ARCHS)
def test_configs_equal_the_reference(arch):
    assert configs.ARCHS == jax_configs.ARCHS
    for smoke in (False, True):
        got = configs.get_config(arch, smoke=smoke)
        want = jax_configs.get_config(arch, smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_counts() == want.param_counts()
        assert [dataclasses.asdict(s) for s in got.period_specs()] == [
            dataclasses.asdict(s) for s in want.period_specs()
        ]
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


# -- layers ------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_match(norm):
    cfg = tiny(norm=norm)
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (2, 5, 64)).astype(np.float32)
    p = {"scale": rng.normal(1, 0.1, 64).astype(np.float32)}
    if norm == "layernorm":
        p["bias"] = rng.normal(0, 0.1, 64).astype(np.float32)
    got = L.apply_norm(cfg, {k: _t(v) for k, v in p.items()}, _t(x))
    want = JL.apply_norm(_jax_cfg(cfg), {k: jnp.asarray(v) for k, v in p.items()}, x)
    _close(got, want)
    h = rng.normal(0, 1, (2, 5, 4, 16)).astype(np.float32)
    s = rng.normal(1, 0.1, 16).astype(np.float32)
    _close(L.rms_head_norm(_t(h), _t(s), 1e-6), JL.rms_head_norm(h, s, 1e-6))


@pytest.mark.parametrize("rotary_pct", [1.0, 0.25, 0.0])
def test_rope_matches(rotary_pct):
    cfg = tiny(rotary_pct=rotary_pct, head_dim=32, rope_theta=1e6)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    _close(L.apply_rope(cfg, _t(x), _t(pos)), JL.apply_rope(_jax_cfg(cfg), x, pos))


@pytest.mark.parametrize("qk_norm,bias", [(True, False), (False, True)])
def test_project_qkv_matches(qk_norm, bias):
    cfg = tiny(qk_norm=qk_norm, use_bias=bias, head_dim=32)
    jp, tp = _params(cfg)
    jblock, tblock = jp["scan"][0]["attn"], tp["scan"][0]["attn"]
    jblock = jax.tree_util.tree_map(lambda t: t[0], jblock)
    tblock = T.tree_map(lambda t: t[0], tblock)
    x = np.random.default_rng(3).normal(0, 1, (2, 6, 64)).astype(np.float32)
    got = L._project_qkv(cfg, tblock, _t(x))
    want = JL._project_qkv(_jax_cfg(cfg), jblock, jnp.asarray(x))
    for g, w in zip(got, want, strict=True):
        _close(g, w)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches(act):
    cfg = tiny(act=act)
    jp, tp = _params(cfg)
    jm = jax.tree_util.tree_map(lambda t: t[0], jp["scan"][0]["mlp"])
    tm = T.tree_map(lambda t: t[0], tp["scan"][0]["mlp"])
    x = np.random.default_rng(4).normal(0, 1, (2, 6, 64)).astype(np.float32)
    _close(L.apply_mlp(cfg, tm, _t(x)), JL.apply_mlp(_jax_cfg(cfg), jm, jnp.asarray(x)))


@pytest.mark.parametrize(
    "kw",
    [
        dict(tie_embeddings=True),
        dict(tie_embeddings=False),
        dict(tie_embeddings=True, scale_embeddings=True, final_logit_softcap=30.0),
    ],
)
def test_embed_and_logits_match(kw):
    cfg = tiny(**kw)
    jp, tp = _params(cfg)
    toks = np.random.default_rng(5).integers(0, 256, (2, 9)).astype(np.int32)
    jx = JL.embed_tokens(_jax_cfg(cfg), jp["embed"], jnp.asarray(toks))
    tx = L.embed_tokens(cfg, tp["embed"], _t(toks))
    _close(tx, jx)
    _close(L.lm_logits(cfg, tp["embed"], tx), JL.lm_logits(_jax_cfg(cfg), jp["embed"], jx))


# -- KV cache ----------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 3, 8, 13])
def test_update_cache_matches(S):
    """S = 1 (indexed write), S < C, S = C and S > C (ring wrap, tail)."""
    cfg = tiny()
    C = 8
    rng = np.random.default_rng(S)
    jc = JK.init_kv_cache(_jax_cfg(cfg), 2, C)
    tc = K.init_kv_cache(cfg, 2, C)
    for step in range(3):  # several writes from different depths
        n = S if step == 1 else 1 + step
        k = rng.normal(0, 1, (2, n, 2, 16)).astype(np.float32)
        v = rng.normal(0, 1, (2, n, 2, 16)).astype(np.float32)
        pos = (np.asarray(jc["idx"])[:, None] + np.arange(n)).astype(np.int32)
        jc, *jall = JK.update_cache(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
        tc, *tall = K.update_cache(tc, _t(k), _t(v), _t(pos))
        for name in ("k", "v", "pos", "idx"):
            np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
        for g, w in zip(tall, jall, strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert K.layer_capacity(cfg, False, 64) == 64
    ring = tiny(sliding_window=8)
    assert K.layer_capacity(ring, True, 64) == JK.layer_capacity(_jax_cfg(ring), True, 64)


# -- whole model ---------------------------------------------------------------

MODELS = {
    "qwen3-smoke": configs.get_config("qwen3-0.6b", smoke=True),
    "gemma2-smoke": configs.get_config("gemma2-9b", smoke=True),
}


N_DECODE = 6


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    """Converted parameters and the JAX package's run on them, once per
    model: forward logits; prefill of 12 tokens into a 16-slot cache, then
    N_DECODE decode steps (the local layers' 8-slot rings wrap, and the
    window and softcap masks bite)."""
    cfg = MODELS[request.param]
    jcfg = _jax_cfg(cfg)
    jp, tp = _params(cfg)
    rng = np.random.default_rng(7)
    run = {"tokens": rng.integers(2, cfg.vocab_size, (2, 20)).astype(np.int32)}
    run["forward"] = np.asarray(JM.forward(jcfg, jp, jnp.asarray(run["tokens"]))[0])
    run["prompt"] = rng.integers(2, cfg.vocab_size, (2, 12)).astype(np.int32)
    run["steps"] = rng.integers(2, cfg.vocab_size, (N_DECODE, 2)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, jnp.asarray(run["prompt"]), JT.init_caches(jcfg, 2, 16))
    run["logits"] = [np.asarray(jl)]
    for i, tok in enumerate(run["steps"]):
        pos = jnp.full((2,), 12 + i, jnp.int32)
        jl, jc = JM.decode_step(jcfg, jp, jnp.asarray(tok), pos, jc)
        run["logits"].append(np.asarray(jl))
    run["cache"] = {n: np.asarray(x) for n, x in jc["scan"][0].items()}
    return cfg, jp, tp, run


@pytest.mark.parametrize("plain", [False, True])
def test_forward_matches(model, plain):
    cfg, _, tp, run = model
    before = flash_attention.launches
    got, _ = M.forward(cfg, tp, _t(run["tokens"]), plain_attention=plain)
    assert flash_attention.launches == before  # CPU: the plain versions
    _close(got, run["forward"])


def test_forward_matches_with_layernorm_bias_and_partial_rope():
    """stablelm's features (layernorm, biases, rotary_pct 0.25) end to end."""
    cfg = tiny("st", norm="layernorm", use_bias=True, rotary_pct=0.25)
    jp, tp = _params(cfg)
    toks = np.random.default_rng(6).integers(2, cfg.vocab_size, (2, 16)).astype(np.int32)
    want, _, _ = JM.forward(_jax_cfg(cfg), jp, jnp.asarray(toks))
    _close(M.forward(cfg, tp, _t(toks))[0], want)


@pytest.mark.parametrize("plain", [False, True])
def test_prefill_and_decode_match(model, plain):
    cfg, _, tp, run = model
    tl, tc = M.prefill(
        cfg, tp, _t(run["prompt"]), T.init_caches(cfg, 2, 16), plain_attention=plain
    )
    got = [tl]
    for i, tok in enumerate(run["steps"]):
        pos = torch.full((2,), 12 + i, dtype=torch.int32)
        tl, tc = M.decode_step(cfg, tp, _t(tok), pos, tc, plain_attention=plain)
        got.append(tl)
    for g, w in zip(got, run["logits"], strict=True):
        _close(g, w)
    for name, want in run["cache"].items():
        np.testing.assert_allclose(tc["scan"][0][name].numpy(), want, **TOL)


def test_greedy_generate_tokens_equal(model):
    cfg, jp, tp, _ = model
    prompt = np.random.default_rng(8).integers(2, cfg.vocab_size, (2, 9)).astype(np.int32)
    want = JM.greedy_generate(_jax_cfg(cfg), jp, jnp.asarray(prompt), 6, max_seq=32)
    got = M.greedy_generate(cfg, tp, _t(prompt), 6, max_seq=32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_is_seeded_with_the_reference_scales():
    cfg = configs.get_config("qwen3-0.6b", smoke=True)
    a = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    b = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = JM.init(_jax_cfg(cfg), jax.random.PRNGKey(0))
    assert set(a) == set(ref) and len(a["scan"]) == len(ref["scan"])
    flat_a = jax.tree_util.tree_leaves(T.tree_map(np.asarray, a))
    flat_b = jax.tree_util.tree_leaves(T.tree_map(np.asarray, b))
    flat_r = jax.tree_util.tree_leaves(ref)
    assert len(flat_a) == len(flat_r)
    for x, y, r in zip(flat_a, flat_b, flat_r, strict=True):
        np.testing.assert_array_equal(x, y)
        assert x.shape == r.shape and x.dtype == np.asarray(r).dtype
        # same distribution: std within 15 % (ones stay ones)
        np.testing.assert_allclose(x.std(), np.asarray(r).std(), rtol=0.15, atol=1e-6)
        np.testing.assert_allclose(x.mean(), np.asarray(r).mean(), atol=0.05)


def test_cast_params_casts_products_and_keeps_norms():
    cfg = dataclasses.replace(configs.get_config("qwen3-0.6b", smoke=True), dtype="bfloat16")
    p = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    c = M.cast_params(cfg, p)
    assert c["embed"]["embedding"].dtype == torch.bfloat16
    assert c["scan"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert c["scan"][0]["attn"]["q_norm"].dtype == torch.float32
    assert c["scan"][0]["norm1"]["scale"].dtype == torch.float32
    assert c["final_norm"]["scale"].dtype == torch.float32
    toks = torch.tensor([[5, 9, 13, 2]])
    a, _ = M.forward(cfg, p, toks)
    b, _ = M.forward(cfg, c, toks)
    assert torch.equal(a, b)  # casting once gives the values of casting per product


def test_unported_blocks_raise():
    """Every block kind is ported: each config builds. The shard-local MoE
    dispatch, the last piece that raised, is ported too: on a one-rank
    (1, 1) mesh it equals the reference's ``apply_moe_shard_map`` on the
    same weights (the 8-rank check is tests/test_torch_perf_paths.py)."""
    import torch_dist_ranks as R
    from jax.sharding import Mesh

    from repro.distributed import sharding as JSh
    from repro.distributed.compat import set_mesh as j_set_mesh
    from repro.models import moe as JMoE
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import moe

    for arch in ("falcon-mamba-7b", "mixtral-8x22b", "llama-3.2-vision-11b"):
        cfg = configs.get_config(arch, smoke=True)
        M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    cfg = dataclasses.replace(configs.get_config("mixtral-8x22b", smoke=True), dtype="float32")
    jcfg = _jax_cfg(cfg)
    jp = JMoE.init_moe(jcfg, jax.random.PRNGKey(0))
    x = np.random.default_rng(0).normal(0, 1, (2, 7, cfg.d_model)).astype(np.float32)
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jrules = JSh.strategy_for(jcfg, jmesh, moe_shard_map=True)
    with JSh.logical_axis_rules(jrules), j_set_mesh(jmesh):
        jy, jaux = jax.jit(lambda p, x: JMoE.apply_moe_shard_map(jcfg, p, x, jrules))(
            jp, jnp.asarray(x))
    with R.process_group("gloo", 1):
        rules = sh.strategy_for(cfg, R.mesh((1, 1), ("data", "model")), moe_shard_map=True)
        with sh.logical_axis_rules(rules):
            y, aux = moe.apply_moe_shard_map(cfg, params_from_reference(jp, "cpu"),
                                             torch.from_numpy(x), rules)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for k in ("aux_loss", "z_loss", "dropped_frac"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **TOL)


def test_decode_route_launch_count_is_zero_on_cpu():
    cfg = MODELS["qwen3-smoke"]
    tp = M.init(cfg, torch.Generator().manual_seed(1), "cpu")
    before = (flash_attention.launches, decode_attention.launches)
    M.greedy_generate(cfg, tp, torch.tensor([[3, 4, 5]]), 3, max_seq=8)
    assert (flash_attention.launches, decode_attention.launches) == before
