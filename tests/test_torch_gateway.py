"""The port's SLO-aware serving gateway vs live runs of the reference.

``repro_torch.serve.gateway`` is a copy of ``repro.serve.gateway`` bound to
the port's ``ServeEngine``. Each test mirrors one of the gateway tests of
``tests/test_serve.py``, runs it on both packages and compares the
reports (``wall_seconds`` and ``n_events`` are telemetry and left out, as
there), the assignment digests and the engines' finished records. The
gateway tests run with the schedule sanitizer on, as the reference's do.
It also holds ``chip_smoke.py``'s pinned gateway plan to the reference.
"""

import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import jax

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.serve import engine as ref_engine
from repro.serve import gateway as ref_gateway
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.serve import engine as port_engine
from repro_torch.serve import gateway as port_gateway

ROOT = Path(__file__).resolve().parent.parent
REF = types.SimpleNamespace(gw=ref_gateway, eng=ref_engine)
PORT = types.SimpleNamespace(gw=port_gateway, eng=port_engine)


@pytest.fixture
def sanitized(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")


def _gw_cfg(P, max_batch=1, **kw):
    ecfg = P.eng.EngineConfig(
        max_batch=max_batch, prefill_cost_per_tok=1e-3, decode_cost_per_tok=0.05
    )
    defaults = dict(ecfg=ecfg, window_s=1.0, shed_backlog_s=0.0, preempt=False)
    defaults.update(kw)
    return P.gw.GatewayConfig(**defaults)


def _spec(P, rid, arrival, tier, dec=20):
    return P.eng.RequestSpec(rid=rid, prompt=32, max_new_tokens=dec, arrival=arrival, tier=tier)


def _report(rep):
    out = dataclasses.asdict(rep)
    for key in ("wall_seconds", "n_events"):  # telemetry, not the record
        out.pop(key)
    return out


def _state(gw):
    """What a run leaves behind: report, assignments, plan order."""
    rows = [(a.task, a.pe, a.start, a.finish, a.energy) for a in gw.drv.eng.assignments]
    return repr((_report(gw.report()), rows, gw.plan_order()))


def _both(scenario, *args):
    return tuple(scenario(P, *args) for P in (REF, PORT))


def _tier_floors(P):
    gw = P.gw.ServingGateway(_gw_cfg(P))
    for rid, tier in enumerate(["best_effort", "batch", "interactive"]):
        gw.offer(_spec(P, rid, 0.0, tier))
    gw.drain()
    prefills = [a.task for a in gw.drv.eng.assignments if a.task.startswith("prefill#")]
    assert prefills == ["prefill#2", "prefill#1", "prefill#0"]
    return _state(gw)


def _shed(P):
    gw = P.gw.ServingGateway(_gw_cfg(P, shed_backlog_s=2.0))
    for i in range(8):
        gw.offer(_spec(P, i, 0.0, "batch"))
    for rid, tier in [(8, "best_effort"), (9, "best_effort"), (10, "batch"),
                      (11, "batch"), (12, "interactive")]:
        gw.offer(_spec(P, rid, 1.5, tier))
    gw.drain()
    per = gw.report().per_tier
    assert per["interactive"]["shed"] == 0 and per["best_effort"]["shed"] == 2
    return _state(gw)


def _preempt(P):
    gw = P.gw.ServingGateway(_gw_cfg(P, preempt=True, preempt_backlog_s=3.0))
    gw.offer(_spec(P, 0, 0.0, "best_effort", dec=200))
    gw.offer(_spec(P, 1, 0.0, "best_effort", dec=200))
    gw.offer(_spec(P, 2, 1.5, "interactive"))
    gw.drain()
    assert gw.drv.n_preemptions == 1
    pre = gw.drv.preemptions[0]
    return repr((pre.victim, pre.victim_pe, pre.resume_floor, pre.displaced)) + _state(gw)


@pytest.mark.parametrize(
    "scenario", [_tier_floors, _shed, _preempt], ids=["tier_floors", "shed", "preempt"]
)
def test_gateway_admission_matches_reference(scenario, sanitized):
    ref, port = _both(scenario)
    assert port == ref


def _restart(P):
    ecfg = P.eng.EngineConfig(max_batch=2, prefill_cost_per_tok=2e-4, decode_cost_per_tok=0.02)
    gcfg = P.gw.GatewayConfig(ecfg=ecfg, window_s=2.0, shed_backlog_s=3.0,
                              preempt_backlog_s=2.0, max_preempt_probes_per_window=4)
    specs = P.gw.synth_requests(150, seed=3, mean_gap=0.3)
    full = P.gw.ServingGateway(gcfg)
    rep_full = full.run(specs)
    w = [int(s.arrival // gcfg.window_s) for s in specs]
    bounds = [i for i in range(1, len(specs)) if w[i] > w[i - 1]]
    k = bounds[len(bounds) // 2]
    gw1 = P.gw.ServingGateway(gcfg)
    for s in specs[:k]:
        gw1.offer(s)
    gw2 = P.gw.ServingGateway.restore(gw1.snapshot(), gcfg=gcfg)
    for s in specs[k:]:
        gw2.offer(s)
    gw2.drain()
    assert _report(gw2.report()) == _report(rep_full)
    return _state(full)


def test_gateway_restart_matches_uninterrupted_and_reference(sanitized):
    ref, port = _both(_restart)
    assert port == ref


def _validation(P):
    gw = P.gw.ServingGateway(_gw_cfg(P))
    gw.offer(_spec(P, 0, 1.0, "batch"))
    errors = []
    for rid, t in ((1, 0.5), (0, 1.5)):
        with pytest.raises(ValueError) as info:
            gw.offer(_spec(P, rid, t, "batch"))
        errors.append(str(info.value))
    return errors


def test_gateway_offer_validation_matches_reference(sanitized):
    ref, port = _both(_validation)
    assert port == ref
    assert "nondecreasing" in port[0] and "duplicate" in port[1]


def test_synth_requests_match_reference():
    for kw in (dict(seed=0, mean_gap=0.2), dict(seed=3, mean_gap=0.3)):
        ref, port = (
            [(s.rid, s.prompt, s.max_new_tokens, s.arrival, s.tier)
             for s in P.gw.synth_requests(64, **kw)]
            for P in (REF, PORT)
        )
        assert repr(port) == repr(ref)


# -- the plan replayed on the engines -----------------------------------------


def _record(eng, done):
    """tests/test_torch_serve.py's record of an engine run."""
    return {
        "requests": {
            r.rid: (list(map(int, r.output)), r.admitted_at, r.finished_at) for r in done
        },
        "clock": eng.clock,
        "ticks": eng.ticks,
        "stats": eng.latency_stats(),
    }


def test_gateway_serve_replays_plan_on_engine(sanitized):
    """Plan with each package's gateway, execute on each package's engine
    (qwen3-0.6b SMOKE, the same converted parameters, real prompt tokens):
    equal plans, equal finished records, and the engine's admissions in
    plan order."""
    jax_cfg = jax_get_config("qwen3-0.6b", smoke=True)
    cfg = get_config("qwen3-0.6b", smoke=True)
    jp = JM.init(jax_cfg, jax.random.PRNGKey(0))
    runs = [(REF, jax_cfg, jp), (PORT, cfg, params_from_reference(jp, "cpu"))]
    out = []
    for P, model_cfg, params in runs:
        rng = np.random.default_rng(7)
        gw = P.gw.ServingGateway(_gw_cfg(P, max_batch=2))
        for i, tier in enumerate(["interactive", "batch", "best_effort", "batch"]):
            prompt = rng.integers(2, cfg.vocab_size, size=6).astype(np.int32)
            gw.offer(P.eng.RequestSpec(rid=i, prompt=prompt, max_new_tokens=3,
                                       arrival=0.4 * i, tier=tier))
        gw.drain()
        rep = gw.report()
        assert rep.n_completed == 4
        ecfg = P.eng.EngineConfig(policy="fcfs", max_batch=2, max_seq=64)
        eng = P.eng.ServeEngine(model_cfg, params, ecfg)
        stats = gw.serve(eng)
        assert stats["n"] == rep.n_completed
        for r in eng.finished:
            assert len(r.output) == r.max_new_tokens + 1
        by_admission = sorted(eng.finished, key=lambda r: (r.admitted_at, r.arrival))
        assert [r.rid for r in by_admission] == [rid for _, rid in gw.plan_order()]
        eft = P.eng.EngineConfig(policy="eft", max_batch=2, max_seq=64)
        with pytest.raises(ValueError, match="fcfs"):
            gw.serve(P.eng.ServeEngine(model_cfg, params, eft))
        out.append((_state(gw), _record(eng, eng.finished)))
    assert out[1] == out[0]


# -- chip_smoke's gateway phase ---------------------------------------------------


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as module
    finally:
        sys.path.remove(str(ROOT))
    return module


def test_chip_smoke_gateway_pins_equal_the_reference(chip_smoke):
    """chip_smoke's phase 7 asserts its pinned digest and counts on the
    card, where there is no JAX. Here the same trace (its own builder, at
    qwen3-0.6b's vocab) through the reference gateway and the port's gives
    exactly those pins."""
    vocab = get_config("qwen3-0.6b").vocab_size
    pins = []
    for P in (REF, PORT):
        specs = chip_smoke.gateway_trace(P.gw.synth_requests, P.eng.RequestSpec, vocab)
        assert all(isinstance(s.prompt, np.ndarray) for s in specs)
        ecfg = P.eng.EngineConfig(**chip_smoke.GATEWAY_ENGINE)
        gw = P.gw.ServingGateway(P.gw.GatewayConfig(ecfg=ecfg, **chip_smoke.GATEWAY))
        rep = gw.run(specs)
        pins.append(chip_smoke.gateway_pins(gw, rep))
        # the plan reads prompt lengths only: bare counts plan the same
        counts = P.gw.ServingGateway(P.gw.GatewayConfig(ecfg=ecfg, **chip_smoke.GATEWAY))
        assert counts.run(P.gw.synth_requests(chip_smoke.GATEWAY_REQUESTS, seed=0,
                                              mean_gap=0.2)).digest == rep.digest
    assert pins[0] == chip_smoke.GATEWAY_PINS
    assert pins[1] == chip_smoke.GATEWAY_PINS


# -- repro_torch.serve_lm, the counterpart of examples/serve_lm.py ------------


def _lines(text):
    """Printed lines without the wall clocks and the device name."""
    out = []
    for line in text.splitlines():
        line = line.split("  wall ")[0].split(", wall ")[0]
        out.append(line.replace(" on cpu:", ":"))
    return out


def test_serve_lm_prints_what_the_example_prints(capsys):
    import importlib.util

    from repro_torch import serve_lm

    spec = importlib.util.spec_from_file_location("serve_lm_example", ROOT / "examples/serve_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main()
    want = capsys.readouterr().out
    assert serve_lm.main(["--cpu", "--smoke"]) == 0
    got = capsys.readouterr().out
    assert _lines(got) == _lines(want)
    assert "serve_lm OK" in got


def test_serve_lm_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    from repro_torch import serve_lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve_lm.main(["--smoke"])
