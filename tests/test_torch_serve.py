"""The port's ServeEngine vs the JAX package's, on qwen3 SMOKE with the
same (converted) parameters: token streams, admission and finish times,
clock, ticks and latency stats are equal under every policy. Mirrors
tests/test_serve.py's engine tests."""

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as jax_get_config
from repro.core.vos import ValueCurve as JaxValueCurve
from repro.models import model as JM
from repro.serve.engine import EngineConfig as JaxEngineConfig
from repro.serve.engine import RequestSpec as JaxRequestSpec
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.vos import ValueCurve
from repro_torch.models import model as M
from repro_torch.serve import (
    SERVE_POLICIES,
    EngineConfig,
    Request,
    RequestSpec,
    ServeEngine,
)

CFG = get_config("qwen3-0.6b", smoke=True)
JAX_CFG = jax_get_config("qwen3-0.6b", smoke=True)


@pytest.fixture(scope="module")
def params():
    jp = JM.init(JAX_CFG, jax.random.PRNGKey(0))
    return jp, params_from_reference(jp, "cpu")


def _trace(n, seed=0, arrival_gap=0.5):
    """(rid, prompt, max_new_tokens, arrival, deadline) as in test_serve.py."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(2, CFG.vocab_size, size=int(rng.integers(4, 12)))
        out.append(
            (
                i,
                prompt.astype(np.int32),
                int(rng.integers(3, 8)),
                i * arrival_gap,
                i * arrival_gap + float(rng.uniform(40, 200)),
            )
        )
    return out


def _requests(trace, spec, curve):
    return [
        spec(rid=r, prompt=p, max_new_tokens=m, arrival=a, curve=curve.step(d))
        for r, p, m, a, d in trace
    ]


def _record(eng, done):
    return {
        "requests": {
            r.rid: (list(map(int, r.output)), r.admitted_at, r.finished_at) for r in done
        },
        "clock": eng.clock,
        "ticks": eng.ticks,
        "stats": eng.latency_stats(),
    }


@pytest.mark.parametrize("policy", ["fcfs", "eft", "edf"])
def test_engine_matches_reference(params, policy):
    jp, tp = params
    trace = _trace(7, seed=len(policy))
    kw = dict(max_batch=3, max_seq=64, policy=policy)
    jeng = JaxServeEngine(JAX_CFG, jp, JaxEngineConfig(**kw))
    teng = ServeEngine(CFG, tp, EngineConfig(**kw))
    for r in _requests(trace, JaxRequestSpec, JaxValueCurve):
        jeng.submit(r)
    for r in _requests(trace, RequestSpec, ValueCurve):
        teng.submit(r)
    want = _record(jeng, jeng.run())
    got = _record(teng, teng.run())
    assert len(got["requests"]) == 7
    assert got == want
    for rid, (out, _, _) in got["requests"].items():
        assert len(out) == trace[rid][2] + 1


def test_continuous_batching_matches_greedy(params):
    _, tp = params
    eng = ServeEngine(CFG, tp, EngineConfig(max_batch=2, max_seq=64, policy="eft"))
    trace = _trace(5)
    for r in _requests(trace, RequestSpec, ValueCurve):
        eng.submit(r)
    done = {r.rid: r for r in eng.run()}
    assert len(done) == 5
    for rid, prompt, n_new, _, _ in trace:
        ref = M.greedy_generate(CFG, tp, torch.from_numpy(prompt)[None], n_new + 1, 64)
        assert ref[0].tolist() == done[rid].output


def test_plain_attention_engine_gives_the_same_tokens(params):
    _, tp = params
    outs = []
    for plain in (False, True):
        eng = ServeEngine(
            CFG, tp, EngineConfig(max_batch=2, max_seq=64, plain_attention=plain)
        )
        for r in _requests(_trace(3, seed=4), RequestSpec, ValueCurve):
            eng.submit(r)
        outs.append({r.rid: r.output for r in eng.run()})
    assert outs[0] == outs[1]


def test_insert_slot_on_the_scanned_layout(params):
    """_insert_slot copies row 0 of a fresh (R, 1, …) cache into batch
    column b of the (R, B, …) engine cache, as the reference does."""
    jp, tp = params
    jeng = JaxServeEngine(JAX_CFG, jp, JaxEngineConfig(max_batch=3, max_seq=16))
    teng = ServeEngine(CFG, tp, EngineConfig(max_batch=3, max_seq=16))
    rng = np.random.default_rng(9)
    fresh = {
        name: rng.normal(0, 1, x.shape[:1] + (1,) + x.shape[2:]).astype(
            np.asarray(x).dtype
        )
        for name, x in jeng.caches["scan"][0].items()
    }
    jeng._insert_slot(1, {"lead": [], "scan": [fresh]})
    teng._insert_slot(1, {"lead": [], "scan": [{n: torch.from_numpy(a) for n, a in fresh.items()}]})
    for name, want in jeng.caches["scan"][0].items():
        got = teng.caches["scan"][0][name]
        assert got.shape[:2] == (CFG.n_repeats, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(teng.caches["scan"][0]["pos"][:, 0], torch.full((2, 16), -1, dtype=torch.int32))


def test_eft_admits_short_jobs_first(params):
    _, tp = params
    long_p = np.arange(2, 12, dtype=np.int32)
    short_p = np.arange(2, 6, dtype=np.int32)
    firsts = {}
    for policy in ("eft", "fcfs"):
        eng = ServeEngine(CFG, tp, EngineConfig(max_batch=1, max_seq=64, policy=policy))
        eng.submit(Request(rid=0, prompt=long_p, max_new_tokens=30))
        eng.submit(Request(rid=1, prompt=short_p, max_new_tokens=2))
        eng.step()
        firsts[policy] = eng.slots[0].rid
    assert firsts == {"eft": 1, "fcfs": 0}


def test_edf_engine_admits_dated_before_undated(params):
    _, tp = params
    eng = ServeEngine(CFG, tp, EngineConfig(max_batch=1, max_seq=64, policy="edf"))
    prompt = np.arange(2, 8, dtype=np.int32)
    eng.submit(RequestSpec(rid=2, prompt=prompt, max_new_tokens=2))
    eng.submit(RequestSpec(rid=0, prompt=prompt, max_new_tokens=2))
    eng.submit(RequestSpec(rid=1, prompt=prompt, max_new_tokens=2, curve=ValueCurve.step(50.0)))
    done = eng.run()
    assert [r.rid for r in sorted(done, key=lambda r: r.admitted_at)] == [1, 0, 2]


def test_idle_clock_jump_and_empty_latency_stats(params):
    _, tp = params
    eng = ServeEngine(CFG, tp, EngineConfig(max_batch=1, max_seq=64, policy="fcfs"))
    assert eng.latency_stats() == {
        "mean_latency": 0.0,
        "p95_latency": 0.0,
        "mean_wait": 0.0,
        "n": 0,
    }
    prompt = np.arange(2, 8, dtype=np.int32)
    eng.submit(RequestSpec(rid=0, prompt=prompt, max_new_tokens=2, arrival=5.0))
    eng.step()
    assert eng.clock == 5.0
    assert len(eng.run()) == 1 and eng.latency_stats()["n"] == 1


def test_rejections(params):
    _, tp = params
    with pytest.raises(ValueError, match="unknown policy"):
        ServeEngine(CFG, None, EngineConfig(policy="lifo"))
    eng = ServeEngine(CFG, tp, EngineConfig(max_batch=1, max_seq=64))
    with pytest.raises(TypeError, match="real prompt tokens"):
        eng.submit(RequestSpec(rid=0, prompt=32, max_new_tokens=2))
    with pytest.raises(ValueError, match="unknown tier"):
        RequestSpec(rid=0, prompt=8, max_new_tokens=2, tier="gold")
    with pytest.warns(DeprecationWarning, match="deadline"):
        r = Request(rid=0, prompt=8, max_new_tokens=2, deadline=7.5)
    assert r.hard_deadline == 7.5
    assert set(SERVE_POLICIES) == {"fcfs", "eft", "edf"}


def test_launcher_trace_and_devices(capsys):
    """``launch/serve`` draws the reference launcher's trace, runs on the
    CPU only when asked, and otherwise wants the card."""
    import warnings

    from repro.launch.serve import synth_requests as jax_synth
    from repro_torch.launch.serve import main, synth_requests

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # its legacy deadline=
        want = jax_synth(JAX_CFG, 6)
    for got, ref in zip(synth_requests(CFG, 6), want, strict=True):
        assert got.prompt.tolist() == ref.prompt.tolist()
        assert (got.max_new_tokens, got.arrival) == (ref.max_new_tokens, ref.arrival)
        assert got.hard_deadline == ref.hard_deadline
    assert main(["--smoke", "--cpu", "--requests", "4", "--policy", "eft"]) == 0
    assert "eft   finished=  4" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            main(["--smoke", "--requests", "1"])
