"""Every SMOKE config of ``configs.ARCHS`` through the port's whole model
vs the JAX package's, on converted parameters: forward logits and MoE aux
losses, a prefill followed by decode steps (logits and every cache leaf:
KV rings, SSM state), and greedy tokens (f32, rtol = atol = 2e-4; drop
fractions and tokens exact). The VLM gets the frontend stub's patch
embeddings."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jax_configs
from repro.models import frontends as JF
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.models import model as M
from repro_torch.models import transformer as T

TOL = dict(rtol=2e-4, atol=2e-4)
PROMPT, MAX_SEQ, N_DECODE = 12, 16, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module", params=configs.ARCHS)
def run(request):
    """Converted parameters (every leaf nudged by seeded noise) and the
    JAX package's forward, prefill + decode and greedy run on them."""
    arch = request.param
    cfg = configs.get_config(arch, smoke=True)
    jcfg = jax_configs.get_config(arch, smoke=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp = JM.init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    jp = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rng.normal(0, 0.02, x.shape), x.dtype), jp
    )
    out = {"cfg": cfg, "tp": params_from_reference(jp, "cpu")}
    vis = JF.fake_patch_embeddings(jcfg, 2) if cfg.family == "vlm" else None
    out["vision"] = vis
    jvis = None if vis is None else jnp.asarray(vis)
    # jitted once per arch, as the reference's engine runs them (eager
    # calls would trace the scanned period anew on every step)
    forward = jax.jit(lambda p, t, v: JM.forward(jcfg, p, t, vision=v))
    prefill = jax.jit(lambda p, t, c, v: JM.prefill(jcfg, p, t, c, vision=v))
    decode = jax.jit(lambda p, t, pos, c, v: JM.decode_step(jcfg, p, t, pos, c, vision=v))
    greedy = jax.jit(lambda p, t, v: JM.greedy_generate(jcfg, p, t, 6, 32, vision=v))
    out["tokens"] = rng.integers(2, cfg.vocab_size, (2, 20)).astype(np.int32)
    logits, _, aux = forward(jp, jnp.asarray(out["tokens"]), jvis)
    out["forward"], out["aux"] = np.asarray(logits), {k: float(v) for k, v in aux.items()}
    out["prompt"] = rng.integers(2, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    out["steps"] = rng.integers(2, cfg.vocab_size, (N_DECODE, 2)).astype(np.int32)
    jl, jc = prefill(jp, jnp.asarray(out["prompt"]), JT.init_caches(jcfg, 2, MAX_SEQ), jvis)
    out["logits"] = [np.asarray(jl)]
    for i, tok in enumerate(out["steps"]):
        pos = jnp.full((2,), PROMPT + i, jnp.int32)
        jl, jc = decode(jp, jnp.asarray(tok), pos, jc, jvis)
        out["logits"].append(np.asarray(jl))
    out["caches"] = jax.tree_util.tree_map(np.asarray, jc)
    out["greedy_prompt"] = rng.integers(2, cfg.vocab_size, (2, 9)).astype(np.int32)
    out["greedy"] = np.asarray(greedy(jp, jnp.asarray(out["greedy_prompt"]), jvis))
    return out


def _vision(run):
    return None if run["vision"] is None else _t(run["vision"])


def test_forward_matches(run):
    cfg = run["cfg"]
    logits, caches, aux = M.forward(
        cfg, run["tp"], _t(run["tokens"]), vision=_vision(run), return_aux=True
    )
    assert caches is None
    _close(logits, run["forward"])
    assert set(aux) == set(run["aux"]) == set(T.AUX_KEYS)
    for k in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[k]), run["aux"][k], **TOL)
    assert float(aux["dropped_frac"]) == run["aux"]["dropped_frac"]
    if not cfg.n_experts:
        assert all(float(v) == 0.0 for v in aux.values())
    # the default return keeps its two values: logits, caches
    two = M.forward(cfg, run["tp"], _t(run["tokens"]), vision=_vision(run))
    assert len(two) == 2 and torch.equal(two[0], logits)


def test_prefill_and_decode_match(run):
    cfg = run["cfg"]
    tc = T.init_caches(cfg, 2, MAX_SEQ)
    tl, tc = M.prefill(cfg, run["tp"], _t(run["prompt"]), tc, vision=_vision(run))
    got = [tl]
    for i, tok in enumerate(run["steps"]):
        pos = torch.full((2,), PROMPT + i, dtype=torch.int32)
        tl, tc = M.decode_step(cfg, run["tp"], _t(tok), pos, tc, vision=_vision(run))
        got.append(tl)
    for g, w in zip(got, run["logits"], strict=True):
        _close(g, w)
    # every cache leaf, written in place: KV rings, SSM h and conv rings;
    # cross-attention positions hold {}
    want = jax.tree_util.tree_leaves_with_path(run["caches"])
    have = jax.tree_util.tree_leaves_with_path(T.tree_map(lambda x: x.numpy(), tc))
    assert [p for p, _ in have] == [p for p, _ in want]
    for (path, g), (_, w) in zip(have, want, strict=True):
        assert g.dtype == w.dtype, path
        np.testing.assert_allclose(g, w, **TOL, err_msg=str(path))


def test_greedy_generate_tokens_equal(run):
    got = M.greedy_generate(
        run["cfg"], run["tp"], _t(run["greedy_prompt"]), 6, 32, vision=_vision(run)
    )
    np.testing.assert_array_equal(got.numpy(), run["greedy"])


def test_stateless_forward_keeps_empty_caches(run):
    """``{}`` caches are a stateless pass, as in the reference: the logits
    of the cacheless forward, and nothing written."""
    cfg = run["cfg"]
    empty = {"lead": [{} for _ in range(cfg.first_k_dense)], "scan": [{} for _ in cfg.period_specs()]}
    logits, caches = M.forward(cfg, run["tp"], _t(run["tokens"]), vision=_vision(run), caches=empty)
    assert caches is empty and all(c == {} for c in caches["lead"] + caches["scan"])
    _close(logits, run["forward"])


@pytest.mark.parametrize(
    "arch",
    ["mixtral-8x22b", "kimi-k2-1t-a32b", "falcon-mamba-7b", "llama-3.2-vision-11b", "jamba-v0.1-52b"],
)
def test_init_is_seeded_with_the_reference_tree(arch):
    """The port's own ``init`` for the MoE, Mamba and cross-attention
    blocks: the reference's tree, shapes and dtypes, seeded, with its
    per-leaf scales (std within 15 %, mean within four standard errors;
    constant leaves equal)."""
    cfg = configs.get_config(arch, smoke=True)
    a = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    b = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = JM.init(jax_configs.get_config(arch, smoke=True), jax.random.PRNGKey(0))
    flat_a = jax.tree_util.tree_leaves_with_path(T.tree_map(np.asarray, a))
    flat_b = jax.tree_util.tree_leaves(T.tree_map(np.asarray, b))
    flat_r = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_r]
    for (path, x), y, (_, r) in zip(flat_a, flat_b, flat_r, strict=True):
        r = np.asarray(r)
        np.testing.assert_array_equal(x, y)
        assert x.shape == r.shape and x.dtype == r.dtype, path
        if r.std() == 0 or "A_log" in str(path):  # ones, zeros, S4D-real A
            np.testing.assert_allclose(x, r, rtol=1e-6, err_msg=str(path))
        else:
            np.testing.assert_allclose(x.std(), r.std(), rtol=0.15, err_msg=str(path))
            sem = r.std() / np.sqrt(r.size)
            np.testing.assert_allclose(x.mean(), r.mean(), atol=4 * sem + 1e-6, err_msg=str(path))


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "jamba-v0.1-52b", "llama-3.2-vision-11b"])
def test_params_from_reference_carries_every_subtree(arch):
    """Mamba, MoE (router, experts, shared MLP) and cross-attention leaves,
    lead blocks and the scanned (R, …) stacks, leaf for leaf; bf16 too."""
    jcfg = jax_configs.get_config(arch, smoke=True)
    ref = JM.init(jcfg, jax.random.PRNGKey(2))
    for dtype in (None, torch.bfloat16):
        got = params_from_reference(ref, "cpu", dtype)
        have = jax.tree_util.tree_leaves_with_path(T.tree_map(lambda t: t.float().numpy(), got))
        want = jax.tree_util.tree_leaves_with_path(ref)
        assert [p for p, _ in have] == [p for p, _ in want]
        names = {str(k) for p, _ in have for k in p}
        assert {"['mamba']", "['moe']", "['xattn']", "['shared']"} & names
        for (path, g), (_, w) in zip(have, want, strict=True):
            w = np.asarray(w)
            assert g.shape == w.shape, path
            if dtype is None:
                np.testing.assert_array_equal(g, w, err_msg=str(path))
            else:
                np.testing.assert_allclose(g, w, rtol=2**-8, atol=1e-30, err_msg=str(path))
