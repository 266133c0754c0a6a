"""Whole runs of tiny cells on the CPU (the engine's plain kernels): a
sound run comes out correct, and each fault a serving cell can have,
planted under the timed path, comes out not correct."""

import time

import pytest
import torch

import serve_bench.run as R
from serve_bench.registry import Registry
from serve_bench import weights as W
from serve_bench.model import ModelShape

from tiny import TINY_CONFIG, make_tree


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tree")
    return Registry(tmp, make_tree(tmp))


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.closed"])
def test_sound_run_is_correct(reg, cell):
    out = R.run_cell(reg, cell, 2**31 + 11, 1.0, False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["sample"]["served_tokens"] > 0
    assert list(out)[-1] == "checks"
    names = {m["name"] for m in reg.metrics_of("end_to_end", cell)}
    assert set(out["metrics"]) == names
    assert all(v["value"] > 0 for v in out["metrics"].values())


def _token_altered(eng):
    """A served token altered where it is produced."""
    emit = eng._emit

    def bad(req, token, out):
        emit(req, (token + 1) % eng.cfg.model.vocab_size, out)
    eng._emit = bad


def _state_unchanged(eng):
    """Every step attends the KV cache as it stood before the first one."""
    import flashinfer_tpu_torch.serving.engine as E

    run, frozen = E.run_device_plan, {}

    def bad(dplan, q, k, v, **kw):
        key = id(k)
        if key not in frozen:
            frozen[key] = (k.clone(), v.clone())
        return run(dplan, q, *frozen[key], **kw)
    eng._restore = run
    E.run_device_plan = bad


def _half_batch_left_out(eng):
    """Half of the live slots of every decode step dropped from the step
    (their K/V never written, their tokens drawn all the same), the other
    half on the next step."""
    step_tokens, calls = eng._step_tokens, [0]

    def bad(reqs):
        tokens, valid = step_tokens(reqs)
        live = valid.nonzero()[0]
        valid[live[calls[0] % 2::2]] = 0
        calls[0] += 1
        return tokens, valid
    eng._step_tokens = bad


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _half_batch_left_out],
                         ids=["token_altered", "state_unchanged",
                              "half_batch_left_out"])
def test_planted_fault_is_not_correct(reg, fault):
    import flashinfer_tpu_torch.serving.engine as E

    run = E.run_device_plan
    try:
        out = R.run_cell(reg, "tiny.chat", 2**31 + 11, 1.0, False,
                         device="cpu", hook=fault)
    finally:
        E.run_device_plan = run
    assert not out["correct"], out["checks"]


def test_weights_drawn_in_place_equal_fresh():
    m = ModelShape.from_config(TINY_CONFIG)
    dev = torch.device("cpu")
    params = W.fill_params(m, 99, dev)
    for i in range(m.layers):
        fresh = W.layer(m, 99, i, dev)
        for name in W.LAYER_MATS:
            assert torch.equal(params[name][i], fresh[name])
    assert torch.equal(params["lm_head"], W.draw(m, 99, "lm_head", -1, dev))
    W.fill_params(m, 100, dev, params=params)
    assert not torch.equal(params["wo"][0], W.layer(m, 99, 0, dev)["wo"])


class _SlowTracer:
    """Stands in for the profiler: slices of two steps at steps 2 and 6,
    each taking ``pause`` seconds to start and to stop."""
    pause = 0.25

    def __init__(self, out_dir):
        self.slices, self._open, self.calls = [], None, 0

    def warm(self, step_fn):
        pass

    @property
    def active(self):
        return self._open is not None

    def before(self, k):
        if k not in (2, 6):
            return False
        time.sleep(self.pause)
        self._open, self.calls = k + 1, self.calls + 1
        return True

    def after(self, k):
        if self._open is None or k < self._open:
            return False
        time.sleep(self.pause)
        self._open, self.calls = None, self.calls + 1
        return True

    def close(self):
        self._open = None


def test_tracer_pauses_are_left_out_of_the_window(reg, monkeypatch):
    import serve_bench.serve as S

    monkeypatch.setattr(S, "Tracer", _SlowTracer)
    sess = S.Session(reg, "tiny.chat", 2**31 + 11, torch.device("cpu"),
                     True, time.perf_counter())
    sess.warm_up()
    t = time.perf_counter()
    run = sess.measure(1.0)
    wall = time.perf_counter() - t
    paused = sess.tracer.calls * _SlowTracer.pause
    assert sess.tracer.calls == 4
    assert run.window_s <= 1.0 + 0.2 < wall - paused + 0.2
    assert wall >= run.window_s + paused
    assert 0 < run.traced_s < 1.0
    assert sum(s.traced for s in run.steps) == 4
    # no gap between two tokens, and no wait for a first one, holds a pause
    assert max(run.itl_s) < _SlowTracer.pause


def test_order_seed_serves_the_mix_in_another_order(reg):
    from serve_bench.serve import Session

    base = Session(reg, "tiny.chat", 5, torch.device("cpu"), False,
                   time.perf_counter())
    other = Session(reg, "tiny.chat", 5, torch.device("cpu"), False,
                    time.perf_counter(), order_seed=99)
    assert other.mix == dict(base.mix, order_seed=99)
