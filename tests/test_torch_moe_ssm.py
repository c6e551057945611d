"""The port's MoE, Mamba, frontend and cross-attention modules vs the JAX
package's, on the same seeded inputs and converted parameters (f32,
rtol = atol = 2e-4; drop fractions, tie orders and frontend arrays
exact)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jax_configs
from repro.models import frontends as JF
from repro.models import layers as JL
from repro.models import moe as JMoE
from repro.models import ssm as JS
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import frontends, moe, ssm
from repro_torch.models import layers as L

TOL = dict(rtol=2e-4, atol=2e-4)


def _jcfg(cfg):
    return JaxModelConfig(**dataclasses.asdict(cfg))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), **TOL)


def _smoke(arch, **kw):
    return dataclasses.replace(configs.get_config(arch, smoke=True), **kw)


def _noisy(tree, seed, noise=0.05):
    """Every leaf nudged by seeded noise, so norm scales, biases, conv
    biases and D are not all ones and zeros."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rng.normal(0, noise, x.shape), x.dtype), tree
    )


# -- MoE ---------------------------------------------------------------------

MOE_CASES = {
    "mixtral": _smoke("mixtral-8x22b"),
    "kimi shared expert": _smoke("kimi-k2-1t-a32b"),
    "jamba": _smoke("jamba-v0.1-52b"),
    # tests/test_models.py:114's capacity: tokens beyond it are dropped
    "capacity drops": _smoke("mixtral-8x22b", capacity_factor=0.25),
    "gelu, drops, shared": _smoke("kimi-k2-1t-a32b", act="gelu", capacity_factor=0.5),
}


def _moe_run(cfg, seed, router_scale=None, shape=(3, 11)):
    jcfg = _jcfg(cfg)
    jp = _noisy(JMoE.init_moe(jcfg, jax.random.PRNGKey(seed)), seed)
    if router_scale is not None:
        jp["router"] = jp["router"] * router_scale
    x = np.random.default_rng(seed).normal(0, 1, shape + (cfg.d_model,)).astype(np.float32)
    # jitted, as the reference runs it: XLA's float32 arithmetic of the
    # drop fraction is what the port reproduces bit for bit
    want = jax.jit(lambda p, x: JMoE.apply_moe(jcfg, p, x))(jp, jnp.asarray(x))
    got = moe.apply_moe(cfg, params_from_reference(jp, "cpu"), _t(x))
    return got, want


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_matches(case):
    cfg = MOE_CASES[case]
    (y, aux), (jy, jaux) = _moe_run(cfg, seed=len(case))
    _close(y, jy)
    assert set(aux) == set(jaux) == {"aux_loss", "z_loss", "dropped_frac"}
    _close(aux["aux_loss"], jaux["aux_loss"])
    _close(aux["z_loss"], jaux["z_loss"])
    assert aux["dropped_frac"].dtype == torch.float32
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
    if "drops" in case:
        assert float(aux["dropped_frac"]) > 0


def test_moe_top_k_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same probability: the top-k
    experts are the first k, as ``jax.lax.top_k`` orders ties, and the
    capacity fills token-major."""
    cfg = _smoke("mixtral-8x22b", capacity_factor=0.5)
    (y, aux), (jy, jaux) = _moe_run(cfg, seed=3, router_scale=0.0)
    _close(y, jy)
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"]) > 0
    w, ids = moe._top_k(torch.full((4, 6), 1 / 6), 2)
    assert ids.tolist() == [[0, 1]] * 4 and torch.equal(w, torch.full((4, 2), 1 / 6))


@pytest.mark.parametrize("tokens", [1, 7, 40, 333])
def test_capacity_matches(tokens):
    for cfg in MOE_CASES.values():
        assert moe._capacity(cfg, tokens) == JMoE._capacity(_jcfg(cfg), tokens)


def test_moe_shard_map_waits_for_the_distributed_port():
    """The distributed port has come: ``apply_moe_shard_map`` on a one-rank
    (1, 1) mesh equals the reference's on the same (noisy) weights, with
    a shared expert and drops (the 8-rank check is
    tests/test_torch_perf_paths.py)."""
    import torch_dist_ranks as R
    from jax.sharding import Mesh

    from repro.distributed import sharding as JSh
    from repro.distributed.compat import set_mesh as j_set_mesh
    from repro_torch.distributed import sharding as sh

    cfg = MOE_CASES["gelu, drops, shared"]
    jcfg = _jcfg(cfg)
    jp = _noisy(JMoE.init_moe(jcfg, jax.random.PRNGKey(5)), 5)
    x = np.random.default_rng(5).normal(0, 1, (3, 11, cfg.d_model)).astype(np.float32)
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jrules = JSh.strategy_for(jcfg, jmesh, moe_shard_map=True)
    with JSh.logical_axis_rules(jrules), j_set_mesh(jmesh):
        jy, jaux = jax.jit(lambda p, x: JMoE.apply_moe(jcfg, p, x))(jp, jnp.asarray(x))
    with R.process_group("gloo", 1):
        rules = sh.strategy_for(cfg, R.mesh((1, 1), ("data", "model")), moe_shard_map=True)
        with sh.logical_axis_rules(rules):
            y, aux = moe.apply_moe(cfg, params_from_reference(jp, "cpu"), _t(x))
    _close(y, jy)
    _close(aux["aux_loss"], jaux["aux_loss"])
    _close(aux["z_loss"], jaux["z_loss"])
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"]) > 0


# -- Mamba ---------------------------------------------------------------------

MAMBA = _smoke("falcon-mamba-7b")  # ssm_chunk 16


def _mamba_params(cfg, seed):
    jp = _noisy(JS.init_mamba(_jcfg(cfg), jax.random.PRNGKey(seed)), seed, noise=0.02)
    return jp, params_from_reference(jp, "cpu")


def _state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return {
        "h": rng.normal(0, 0.5, (b, cfg.d_inner, cfg.ssm_state)).astype(np.float32),
        "conv": rng.normal(0, 0.5, (b, cfg.ssm_conv - 1, cfg.d_inner)).astype(np.float32),
    }


@pytest.mark.parametrize(
    "s,with_state",
    [(1, True), (1, False), (48, False), (48, True), (20, True), (16, False), (2, True)],
    ids=["decode", "decode-fresh", "3-chunks", "3-chunks-state", "ragged", "one-chunk", "S=2"],
)
def test_mamba_matches(s, with_state):
    """S = 1 (the decode path), S a multiple of the chunk (several chunks,
    the state carried across), and S % chunk != 0 (one chunk of S)."""
    jp, tp = _mamba_params(MAMBA, seed=s)
    x = np.random.default_rng(s + 1).normal(0, 1, (2, s, MAMBA.d_model)).astype(np.float32)
    st = _state(MAMBA, 2, s + 2) if with_state else None
    jstate = None if st is None else jax.tree_util.tree_map(jnp.asarray, st)
    jy, jst = JS.apply_mamba(_jcfg(MAMBA), jp, jnp.asarray(x), state=jstate)
    y, new = ssm.apply_mamba(
        MAMBA, tp, _t(x), state=None if st is None else {k: _t(v) for k, v in st.items()}
    )
    _close(y, jy)
    assert set(new) == set(jst) == {"h", "conv"}
    for k in new:
        assert new[k].dtype == torch.float32  # a float32 config
        _close(new[k], jst[k])


def test_mamba_state_is_float32_under_bf16():
    cfg = dataclasses.replace(MAMBA, dtype="bfloat16")
    _, tp = _mamba_params(cfg, seed=5)
    x = torch.randn(1, 32, cfg.d_model, generator=torch.Generator().manual_seed(5))
    st = ssm.init_ssm_state(cfg, 1)
    assert (st["h"].dtype, st["conv"].dtype) == (torch.float32, torch.bfloat16)
    y, new = ssm.apply_mamba(cfg, tp, x.to(torch.bfloat16), state=st)
    assert y.dtype == torch.bfloat16 and new["h"].dtype == torch.float32
    assert new["conv"].dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    ref = JS.init_ssm_state(_jcfg(cfg), 1)
    for k in st:
        assert tuple(st[k].shape) == ref[k].shape


def test_causal_conv_carries_its_state():
    """The conv over a sequence equals the conv over its two halves with
    the ring carried between them, and both equal the reference's."""
    jp, tp = _mamba_params(MAMBA, seed=9)
    x = np.random.default_rng(9).normal(0, 1, (2, 10, MAMBA.d_inner)).astype(np.float32)
    jcfg = _jcfg(MAMBA)
    jy, jring = JS._causal_conv(jcfg, jp, jnp.asarray(x), None)
    y, ring = ssm._causal_conv(MAMBA, tp, _t(x), None)
    _close(y, jy)
    _close(ring, jring)
    a, ring_a = ssm._causal_conv(MAMBA, tp, _t(x[:, :4]), None)
    ja, jring_a = JS._causal_conv(jcfg, jp, jnp.asarray(x[:, :4]), None)
    b, ring_b = ssm._causal_conv(MAMBA, tp, _t(x[:, 4:]), ring_a)
    jb, jring_b = JS._causal_conv(jcfg, jp, jnp.asarray(x[:, 4:]), jring_a)
    _close(torch.cat([a, b], 1), y.detach())
    _close(b, jb)
    _close(ring_b, jring_b)
    _close(ring_b, ring)
    # a 1-token step shifts the ring by one
    c, ring_c = ssm._causal_conv(MAMBA, tp, _t(x[:, :1]), ring)
    jc, jring_c = JS._causal_conv(jcfg, jp, jnp.asarray(x[:, :1]), jring)
    _close(c, jc)
    _close(ring_c, jring_c)


@pytest.mark.parametrize("chunk", [1, 2, 5, 16, 33])
def test_scan_chunk_matches_associative_scan(chunk):
    """The doubling scan against ``lax.associative_scan`` (f32, 2e-4)."""
    rng = np.random.default_rng(chunk)
    da = rng.uniform(0.5, 1.0, (2, chunk, 6, 4)).astype(np.float32)
    dbu = rng.normal(0, 1, (2, chunk, 6, 4)).astype(np.float32)
    h0 = rng.normal(0, 1, (2, 6, 4)).astype(np.float32)
    jh, jlast = JS._scan_chunk(jnp.asarray(da), jnp.asarray(dbu), jnp.asarray(h0))
    h, last = ssm._scan_chunk(_t(da), _t(dbu), _t(h0))
    _close(h, jh)
    _close(last, jlast)
    # the sequential recurrence, position by position
    seq, state = [], h0
    for t in range(chunk):
        state = da[:, t] * state + dbu[:, t]
        seq.append(state)
    np.testing.assert_allclose(h.numpy(), np.stack(seq, 1), **TOL)


def test_ssm_inputs_match():
    jp, tp = _mamba_params(MAMBA, seed=4)
    u = np.random.default_rng(4).normal(0, 1, (2, 5, MAMBA.d_inner)).astype(np.float32)
    want = JS._ssm_inputs(_jcfg(MAMBA), jp, jnp.asarray(u))
    for g, w in zip(ssm._ssm_inputs(MAMBA, tp, _t(u)), want, strict=True):
        _close(g, w)


# -- frontends -------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["musicgen-medium", "llama-3.2-vision-11b"])
@pytest.mark.parametrize("seed", [0, 7])
def test_frontends_bit_equal(arch, seed):
    cfg = configs.get_config(arch, smoke=True)
    jcfg = jax_configs.get_config(arch, smoke=True)
    got = frontends.fake_codec_tokens(cfg, 3, 17, seed=seed)
    want = JF.fake_codec_tokens(jcfg, 3, 17, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if cfg.n_vision_tokens:
        got = frontends.fake_patch_embeddings(cfg, 2, seed=seed)
        want = JF.fake_patch_embeddings(jcfg, 2, seed=seed)
        assert got.shape == (2, cfg.n_vision_tokens, cfg.d_model)
        assert got.dtype == want.dtype and np.array_equal(got, want)


# -- cross-attention and NoPE ------------------------------------------------------

VLM = configs.get_config("llama-3.2-vision-11b", smoke=True)


@pytest.mark.parametrize("sq,skv", [(7, 16), (1, 16), (9, 1)])
def test_cross_attention_block_matches(sq, skv):
    """Sq != Skv, no rope, no cache, not causal: the plain path, as in the
    reference, and no flash launch."""
    jcfg = _jcfg(VLM)
    jp = _noisy(JL.init_attention(jcfg, jax.random.PRNGKey(sq), cross=True), sq)
    tp = params_from_reference(jp, "cpu")
    rng = np.random.default_rng(skv)
    x = rng.normal(0, 1, (2, sq, VLM.d_model)).astype(np.float32)
    vis = rng.normal(0, 1, (2, skv, VLM.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(sq, dtype=np.int32) + 40, (2, sq))
    want, _ = JL.attention_block(
        jcfg, jp, jnp.asarray(x), positions=jnp.asarray(pos), local=False, kv_x=jnp.asarray(vis)
    )
    before = flash_attention.launches
    got, cache = L.attention_block(
        VLM, tp, _t(x), positions=_t(pos), local=False, kv_x=_t(vis)
    )
    assert flash_attention.launches == before and cache is None
    _close(got, want)


def test_nope_attention_leaves_q_and_k_alone():
    """jamba's attention is NoPE (rotary_pct 0): rope is the identity, the
    very tensor back, with nothing computed on it."""
    cfg = configs.get_config("jamba-v0.1-52b")
    assert L._rotary_dim(cfg) == 0
    x = torch.randn(1, 3, cfg.n_heads, cfg.head_dim)
    assert L.apply_rope(cfg, x, torch.zeros(1, 3, dtype=torch.int32)) is x
