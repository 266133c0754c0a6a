"""The serving engine's phase spans and queue stamps, on the CPU at
LlamaConfig.tiny(): each phase of ``step()`` counts its host seconds into
``eng.phases`` always, and is a ``record_function`` range only while a
profiler session records; a request carries its queue wait."""

import json
import time

import numpy as np
import pytest
import torch

from flashinfer_tpu_torch.models.llama import LlamaConfig
from flashinfer_tpu_torch.profiler import annotate
from flashinfer_tpu_torch.serving.engine import (
    EngineConfig,
    LlamaServingEngine,
)

MC = LlamaConfig.tiny()
BASE = dict(max_batch=4, num_pages=64, page_size=8, max_seq_len=128,
            greedy=True, device="cpu")
PHASES = ("plan", "inputs", "upload", "replay", "readback", "emit")


def _engine(**kw):
    return LlamaServingEngine(EngineConfig(model=MC, **{**BASE, **kw}),
                              seed=3)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MC.vocab_size, n).tolist() for n in lens]


def _serve_a_few(eng, steps=4):
    for p in _prompts(1, (9, 4, 21)):
        eng.add_request(p, 8)
    for _ in range(steps):
        eng.step()


@pytest.mark.parametrize("mode,kind", [
    ({}, "decode"), ({"decode_window": 2}, "decode"),
    ({"spec_tokens": 2}, "verify")], ids=["decode", "window", "verify"])
def test_each_phase_counts_its_seconds(mode, kind):
    eng = _engine(**mode)
    _serve_a_few(eng)
    want = {f"prefill.{p}" for p in ("admit",) + PHASES} | {
        f"{kind}.{p}" for p in ("reserve",) + PHASES}
    assert set(eng.phases) == want
    for key, (seconds, entries) in eng.phases.items():
        assert seconds > 0 and entries > 0, key
    # plan_seconds keeps its meaning: decode and verify plans, not prefill
    assert eng.plan_seconds == pytest.approx(eng.phases[kind + ".plan"][0])
    assert eng.phases["prefill.plan"][1] == 1  # one admission, one plan
    if kind == "decode":
        assert eng.phases["decode.plan"][1] == eng.decode_steps


def test_engine_ranges_nest_inside_the_step(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    eng = _engine()
    for p in _prompts(2, (5, 12)):
        eng.add_request(p, 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with torch.profiler.record_function("test.step"):
                eng.step()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    steps = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e["name"] == "test.step"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e["name"].startswith("engine."))
    assert len(steps) == 3
    assert {n for _, _, n in spans} == (
        {f"engine.prefill.{p}" for p in ("admit",) + PHASES}
        | {f"engine.decode.{p}" for p in ("reserve",) + PHASES})
    for s, e, name in spans:
        assert any(a <= s and e <= b for a, b in steps), name
    # the phases follow each other: none opens inside another
    for (_, e0, n0), (s1, _, n1) in zip(spans, spans[1:]):
        assert e0 <= s1, (n0, n1)


def test_no_range_outside_a_session(monkeypatch):
    real, entered = torch.profiler.record_function, []

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    eng = _engine()
    _serve_a_few(eng)
    assert entered == [] and eng.phases
    counters = {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with annotate("engine.test.span", counters, "test.span"):
            pass
    assert entered == ["engine.test.span"]
    assert counters["test.span"][1] == 1


def test_queue_wait_covers_the_steps_it_waited():
    eng = _engine()
    first = [eng.add_request(p, 6) for p in _prompts(3, (5, 6, 7, 8))]
    eng.step()  # all four slots taken
    assert all(r.queue_wait is not None and r.queue_wait >= 0
               for r in first)
    late = eng.add_request(_prompts(4, (6,))[0], 3)
    t0 = time.perf_counter()
    eng.step()
    waited = time.perf_counter() - t0
    assert late.queue_wait is None  # no slot was free
    assert eng.deferred == {"slots": 1, "pages": 0}
    while late.queue_wait is None:
        eng.step()
    assert late.queue_wait >= waited


def test_deferred_for_want_of_pages():
    eng = _engine(max_batch=2, num_pages=4, max_seq_len=32)
    a, b = [eng.add_request(p, 3) for p in _prompts(5, (20, 20))]
    eng.step()
    assert a.queue_wait is not None and b.queue_wait is None
    assert eng.deferred == {"slots": 0, "pages": 1}
    eng.run_to_completion(max_steps=50)
    assert b.done and b.queue_wait > a.queue_wait


def test_preempted_request_keeps_its_first_wait():
    eng = _engine(max_batch=3, num_pages=5, max_seq_len=32)
    reqs = [eng.add_request(p, 10) for p in _prompts(7, (6, 6, 6))]
    eng.step()
    waits = [r.queue_wait for r in reqs]
    assert None not in waits
    eng.run_to_completion(max_steps=300)
    assert eng.preemptions > 0 and all(r.done for r in reqs)
    assert [r.queue_wait for r in reqs] == waits
