"""The port's ServeEngine and serving launcher on the non-dense archs vs
the JAX package's: llama-vision SMOKE with ``vision=`` and jamba SMOKE with
mixed prompt lengths (so ``_insert_slot`` moves Mamba state rows beside KV
rows) give the reference engine's tokens, admission and finish times,
clock, ticks, latency stats and final caches."""

import numpy as np
import pytest
import torch

import jax

from repro import configs as jax_configs
from repro.core.vos import ValueCurve as JaxValueCurve
from repro.models import frontends as JF
from repro.models import model as JM
from repro.serve.engine import EngineConfig as JaxEngineConfig
from repro.serve.engine import RequestSpec as JaxRequestSpec
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.core.vos import ValueCurve
from repro_torch.models import transformer as T
from repro_torch.serve import EngineConfig, RequestSpec, ServeEngine

TOL = dict(rtol=2e-4, atol=2e-4)


def _trace(cfg, lens, seed):
    """(rid, prompt, max_new_tokens, arrival, deadline) per prompt length."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lens):
        prompt = rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
        out.append((i, prompt, int(rng.integers(3, 7)), i * 0.5, i * 0.5 + float(rng.uniform(40, 200))))
    return out


def _record(eng, done):
    return {
        "requests": {
            r.rid: (list(map(int, r.output)), r.admitted_at, r.finished_at) for r in done
        },
        "clock": eng.clock,
        "ticks": eng.ticks,
        "stats": eng.latency_stats(),
    }


def _serve_both(arch, lens, policy, vision=False, max_batch=3, seed=0):
    cfg = configs.get_config(arch, smoke=True)
    jcfg = jax_configs.get_config(arch, smoke=True)
    jp = JM.init(jcfg, jax.random.PRNGKey(seed))
    vis = JF.fake_patch_embeddings(jcfg, 1)[0] if vision else None
    kw = dict(max_batch=max_batch, max_seq=48, policy=policy)
    jeng = JaxServeEngine(jcfg, jp, JaxEngineConfig(**kw), vision=vis)
    teng = ServeEngine(cfg, params_from_reference(jp, "cpu"), EngineConfig(**kw), vision=vis)
    trace = _trace(cfg, lens, seed)
    for r, p, m, a, d in trace:
        req = dict(rid=r, prompt=p, max_new_tokens=m, arrival=a)
        jeng.submit(JaxRequestSpec(**req, curve=JaxValueCurve.step(d)))
        teng.submit(RequestSpec(**req, curve=ValueCurve.step(d)))
    want = _record(jeng, jeng.run())
    got = _record(teng, teng.run())
    assert len(got["requests"]) == len(lens)
    assert got == want
    return jeng, teng


@pytest.mark.parametrize("policy", ["fcfs", "eft"])
def test_vision_engine_matches_reference(policy):
    """Prefill sees ``vision[None, 0]``, decode ``vision`` over every slot,
    as in the reference engine."""
    _, teng = _serve_both("llama-3.2-vision-11b", [5, 9, 5, 12, 9], policy, vision=True)
    cfg = teng.cfg
    assert teng.vision.shape == (cfg.n_vision_tokens, cfg.d_model)
    specs = cfg.period_specs()
    xattn = [c for c, s in zip(teng.caches["scan"], specs, strict=True) if s.mixer == "xattn"]
    assert xattn == [{}]


def test_vision_is_required_by_cross_attention():
    cfg = configs.get_config("llama-3.2-vision-11b", smoke=True)
    jp = JM.init(jax_configs.get_config("llama-3.2-vision-11b", smoke=True), jax.random.PRNGKey(0))
    eng = ServeEngine(cfg, params_from_reference(jp, "cpu"), EngineConfig(max_batch=1, max_seq=16))
    eng.submit(RequestSpec(rid=0, prompt=np.arange(2, 6, dtype=np.int32), max_new_tokens=2))
    with pytest.raises(ValueError, match="vision"):
        eng.run()


@pytest.mark.parametrize("policy", ["fcfs", "edf"])
def test_jamba_engine_moves_mamba_state(policy):
    """Mixed prompt lengths over 2 slots: requests are admitted while
    others decode, so ``_insert_slot`` copies SSM ``h`` and conv rows into
    the stacked (R, B, …) state. Every final cache leaf equals the
    reference's, the state rows included."""
    jeng, teng = _serve_both("jamba-v0.1-52b", [7, 13, 4, 10, 7, 13], policy, max_batch=2)
    want = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jeng.caches))
    have = jax.tree_util.tree_leaves_with_path(T.tree_map(lambda x: x.numpy(), teng.caches))
    assert [p for p, _ in have] == [p for p, _ in want]
    kinds = {str(p[-1]) for p, _ in have}
    assert {"['h']", "['conv']", "['k']", "['v']"} <= kinds
    for (path, g), (_, w) in zip(have, want, strict=True):
        np.testing.assert_allclose(g, w, **TOL, err_msg=str(path))


def test_insert_slot_copies_state_rows_and_skips_cross_attention():
    """One fresh single-row tree into slot 1: KV, SSM ``h`` (float32) and
    conv rows land in batch column 1 of their stacks, other rows stay, and
    a ``{}`` cache takes nothing."""
    cfg = configs.get_config("jamba-v0.1-52b", smoke=True)
    jp = JM.init(jax_configs.get_config("jamba-v0.1-52b", smoke=True), jax.random.PRNGKey(0))
    eng = ServeEngine(cfg, params_from_reference(jp, "cpu"), EngineConfig(max_batch=3, max_seq=16))
    before = T.tree_map(torch.clone, eng.caches)
    fresh = T.init_caches(cfg, 1, 16)
    g = torch.Generator().manual_seed(0)
    fresh = T.tree_map(lambda x: torch.randn(x.shape, generator=g).to(x.dtype), fresh)
    eng._insert_slot(1, fresh)
    for new, old, row in zip(
        T.tree_map(lambda x: x, eng.caches)["scan"], before["scan"], fresh["scan"], strict=True
    ):
        for name in new:
            assert torch.equal(new[name][:, 1], row[name][:, 0])
            assert torch.equal(new[name][:, [0, 2]], old[name][:, [0, 2]])
    mamba = [c for c, s in zip(eng.caches["scan"], cfg.period_specs(), strict=True) if s.mixer == "mamba"]
    assert mamba and all(c["h"].dtype == torch.float32 for c in mamba)

    vlm = configs.get_config("llama-3.2-vision-11b", smoke=True)
    jv = JM.init(jax_configs.get_config("llama-3.2-vision-11b", smoke=True), jax.random.PRNGKey(0))
    veng = ServeEngine(vlm, params_from_reference(jv, "cpu"), EngineConfig(max_batch=2, max_seq=16))
    veng._insert_slot(0, T.init_caches(vlm, 1, 16))
    assert {} in veng.caches["scan"]
