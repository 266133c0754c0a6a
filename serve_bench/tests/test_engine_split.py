"""The reader of the engine's own spans and counters (``engine_split.py``):
idle time put down to the innermost engine span, the benchmark's own
reading left as it was, and ``None`` from an engine without them."""

import json
import random
import types

import pytest

from serve_bench import engine_split as E
from serve_bench.registry import Registry
from serve_bench.serve import StepRec
from serve_bench.trace import read_chrome_trace

from tiny import make_tree


def _ann(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


BENCH_EVENTS = [
    _ann("bench.slice", 0, 100), _ann("bench.step", 0, 60),
    _ann("bench.bookkeeping", 60, 30),
    {"ph": "X", "cat": "kernel", "name": "paged_dec_kernel", "ts": 10,
     "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "nvjet_gemm", "ts": 25, "dur": 15},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 95,
     "dur": 10},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 5},
]
ENGINE_EVENTS = [_ann("engine.decode.plan", 5, 10),
                 _ann("engine.decode.replay", 20, 8),
                 _ann("engine.decode.readback", 30, 25)]


def _write(tmp_path, events):
    path = tmp_path / f"t{len(events)}.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_idle_goes_to_the_innermost_engine_span(tmp_path):
    # idle in the step: 0-10, 20-25, 40-60; plan 5-15, replay 20-28,
    # readback 30-55
    idle = E.engine_idle(BENCH_EVENTS + ENGINE_EVENTS)
    assert idle == pytest.approx({
        "bench.step": 10e-6, "engine.decode.plan": 5e-6,
        "engine.decode.replay": 5e-6, "engine.decode.readback": 15e-6})
    sl = read_chrome_trace(_write(tmp_path, BENCH_EVENTS + ENGINE_EVENTS))
    assert sum(idle.values()) == pytest.approx(sl.idle_by_span["bench.step"])
    sl.idle_by_engine = idle
    split = E.idle_split([sl])  # shares of the 100-us wall
    assert split == pytest.approx({"host": 5.0, "replay": 20.0,
                                   "capture": 0.0, "outside": 10.0,
                                   "outside_of_step": 100 * 10 / 35})
    assert E.idle_in_step([sl, sl]) == pytest.approx(
        {k: 2 * v for k, v in idle.items()})


def test_engine_spans_leave_the_benchmarks_reading_as_it_was(tmp_path):
    plain = read_chrome_trace(_write(tmp_path, BENCH_EVENTS))
    both = read_chrome_trace(_write(tmp_path, BENCH_EVENTS + ENGINE_EVENTS))
    assert both.wall_s == plain.wall_s and both.busy_s == plain.busy_s
    assert both.by_family == plain.by_family
    assert both.idle_by_span == plain.idle_by_span


def _brute(idle, spans):
    """``read_chrome_trace``'s rule: cut each stretch where a span starts or
    ends inside it, each piece to the shortest span around its middle."""
    out = {}
    for g0, g1 in idle:
        cuts = sorted({g0, g1} | {t for h in spans for t in h[:2]
                                  if g0 < t < g1})
        for a, b in zip(cuts, cuts[1:]):
            mid = 0.5 * (a + b)
            inner = [h for h in spans if h[0] <= mid < h[1]]
            if inner:
                k = min(inner, key=lambda h: h[1] - h[0])[2]
                out[k] = out.get(k, 0.0) + (b - a) * 1e-6
    return out


@pytest.mark.parametrize("seed", range(5))
def test_innermost_by_bisection_equals_the_cut_rule(seed):
    rng = random.Random(seed)
    spans, t = [], 0.0
    for i in range(20):  # steps, each a run of phases with gaps between
        s0 = t
        for j in range(rng.randint(1, 6)):
            t += rng.uniform(0, 3)
            d = rng.uniform(0.5, 10)
            spans.append((t, t + d, f"engine.k.p{j}"))
            t += d
        spans.append((s0, t + rng.uniform(0, 2), "bench.step"))
        t += rng.uniform(0, 5)
    idle, c = [], 0.0
    while c < t:
        a = c + rng.uniform(0, 4)
        idle.append((a, a + rng.uniform(0.1, 8)))
        c = idle[-1][1]
    assert E.innermost_idle(idle, spans) == pytest.approx(_brute(idle, spans))


def _step(traced, decode_rows=8, prefill_replays=0):
    rec = StepRec(0.0, 0.02, traced)
    rec.decode_rows, rec.prefill_replays = decode_rows, prefill_replays
    return rec


def test_an_engine_without_counters_reads_none():
    sl = types.SimpleNamespace(wall_s=1.0, idle_by_engine={"bench.step": .3})
    run = types.SimpleNamespace(steps=[_step(False), _step(True)],
                                slices=[sl])
    out = E.readings(run, [(0.0, None), (1.0, None)], None)
    assert out == {"decode_host_ms": None, "queue_wait_p95_ms": None,
                   "idle_split": None}
    # a slice read by the benchmark's own tracer has no engine field
    run.slices = [types.SimpleNamespace(wall_s=1.0)]
    assert E.readings(run, [(0.0, None), (1.0, None)], [])[
        "idle_split"] is None


def test_host_time_of_the_decode_steps_decode_step_ms_reads():
    run = types.SimpleNamespace(
        steps=[_step(False), _step(False), _step(True),
               _step(False, prefill_replays=1)], slices=[])
    calls = [(0.0, {"decode.plan": 0.001, "decode.replay": 0.005,
                    "decode.emit": 0.002}),
             (0.1, {"decode.plan": 0.003, "decode.readback": 0.02}),
             (0.2, {"decode.plan": 0.1}),
             (0.3, {"prefill.plan": 0.1, "decode.plan": 0.1})]
    out = E.readings(run, calls, [0.1, 0.3])
    assert out["decode_host_ms"] == pytest.approx(3.0)  # median of 3, 3
    assert out["phase_ms_untraced"] == pytest.approx({
        "decode.plan": 2.0, "decode.replay": 2.5, "decode.emit": 1.0,
        "decode.readback": 10.0})
    assert out["phase_ms_traced"] == pytest.approx({"decode.plan": 100.0})
    assert out["queue_wait_p95_ms"] == pytest.approx(290.0)


def test_pauses_are_taken_out_of_a_wait():
    assert E.minus_pauses(1.0, 5.0, [(0.0, 1.5), (2.0, 3.0), (4.5, 9)]) \
        == pytest.approx(2.0)
    assert E.minus_pauses(1.0, 2.0, [(3.0, 4.0)]) == pytest.approx(1.0)


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tree")
    return Registry(tmp, make_tree(tmp))


def test_a_cpu_run_reads_the_engine(reg):
    out = E.measure(reg, "tiny.chat", 2**31 + 7, 1.0, False, device="cpu")
    assert out["steps"] > 0 and out["decode_host_ms"] > 0
    assert out["queue_wait_p95_ms"] >= 0
    phases = out["phase_ms_untraced"]
    for p in ("reserve", "inputs", "plan", "upload", "replay", "readback",
              "emit"):
        assert phases["decode." + p] > 0, p
    assert set(out["deferred"]) == {"slots", "pages"}
    assert out["idle_split"] is None  # not traced


def test_recorder_counts_only_from_its_start():
    eng = types.SimpleNamespace(phases={"decode.plan": [0.0, 0]})

    def step():
        eng.phases["decode.plan"][0] += 0.5

    eng.step = step
    rec = E.StepRecorder()
    rec.attach(eng)
    eng.step()  # before the window
    rec.start()
    eng.step()
    eng.step()
    assert [d for _, d in rec.calls] == [{"decode.plan": 0.5}] * 2
