"""The port's single-card tooling against the JAX package's: the FLOP and
byte calculators (exactly), the comparison and quantization oracles (the
e4m3 bits exactly), the autotuner (a persisted winner reaches the launch;
outputs at the tuned tile equal the default tile's to 1e-5 in f32, the
same sums split differently), the CLI, the AOT warm-up, the profiler and
the device-neutral utils (exactly)."""

import itertools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashinfer_tpu import utils as jax_utils
from flashinfer_tpu.testing import utils as jax_tu
from flashinfer_tpu_torch import autotuner as at
from flashinfer_tpu_torch import utils
from flashinfer_tpu_torch.testing import utils as tu


@pytest.mark.parametrize("causal", [False, True])
def test_flops_and_bytes_equal_jax(causal):
    for b, qo, kv, dqk, dvo, hq, hkv in itertools.product(
            (1, 8), (1, 17, 512), (512, 4097), (64, 192), (128,), (8, 32),
            (1, 8)):
        if qo > kv:
            continue
        kw = dict(batch_size=b, qo_len=qo, kv_len=kv, head_dim_qk=dqk,
                  head_dim_vo=dvo, num_qo_heads=hq)
        assert tu.attention_flops(causal=causal, **kw) == \
            jax_tu.attention_flops(causal=causal, **kw)
        assert tu.attention_tflops_per_sec(1e-3, causal=causal, **kw) == \
            jax_tu.attention_tflops_per_sec(1e-3, causal=causal, **kw)
        bkw = dict(kw, num_kv_heads=hkv, kv_itemsize=1 + causal)
        assert tu.attention_bytes(**bkw) == jax_tu.attention_bytes(**bkw)
        assert tu.attention_tb_per_sec(2e-3, **bkw) == \
            jax_tu.attention_tb_per_sec(2e-3, **bkw)
    for m, n, k, batch in itertools.product((1, 4096), (128, 14336),
                                            (64, 7168), (1, 8)):
        assert tu.gemm_flops(m, n, k, batch) == jax_tu.gemm_flops(m, n, k,
                                                                  batch)


def test_assert_close_with_mismatch_tolerance():
    a = np.zeros(100)
    b = np.zeros(100)
    b[7] = 1.0
    for fn in (tu.assert_close_with_mismatch_tolerance,
               jax_tu.assert_close_with_mismatch_tolerance):
        with pytest.raises(AssertionError, match="1 mismatched"):
            fn(a, b)
        fn(a, b, max_mismatched_elements=1)
    tu.assert_close_with_mismatch_tolerance(torch.zeros(4), torch.full(
        (4,), 1e-9), atol=1e-8)
    with pytest.raises(AssertionError):
        tu.assert_close_with_mismatch_tolerance(torch.zeros(4),
                                                torch.ones(4))


def test_quantize_fp8_rowwise_ref_equals_jax_bits():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 64)) * rng.uniform(0.01, 100, (6, 1))
         ).astype(np.float32)
    x[2] = 0.0  # a zero row: scale 1
    jq, js = jax_tu.quantize_fp8_rowwise_ref(x)
    q, s = tu.quantize_fp8_rowwise_ref(x)
    assert q.dtype == torch.float8_e4m3fn and s.dtype == torch.float32
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                  np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(s.numpy(), js)


def test_benchers_time_on_the_cpu():
    x = torch.ones(64, 64)
    assert tu.bench_gpu_time(torch.matmul, x, x, warmup=1, repeats=3) > 0
    dt = tu.bench_gpu_time_differential(
        lambda c, w: c * w, torch.ones(128, 128), torch.full((128, 128),
                                                             1.0001),
        n_short=1, n_long=3, repeats=2)
    assert dt > 0


@pytest.fixture
def tuner_path(tmp_path, monkeypatch):
    path = tmp_path / "cfg.json"
    monkeypatch.setattr(at, "get_config_path", lambda: str(path))
    monkeypatch.setattr(at.AutoTuner, "_instance", None)
    return path


def test_autotuner_choose_and_cache(tuner_path):
    tuner = at.AutoTuner()

    class R(at.TunableRunner):
        def get_valid_tactics(self):
            return [{"tile": 128}, {"tile": 256}, {"tile": 512}]

        def run(self, tactic, *args):
            return tactic

    assert tuner.choose_one("op_a", R())["tile"] == 128  # off: the first
    times = {128: 3.0, 256: 1.0, 512: 2.0}
    tuner.enabled = True
    best = tuner.choose_one("op_b", R(), time_tactic=lambda t: times[
        t["tile"]])
    assert best["tile"] == 256 and tuner.stats.profiled_tactics == 3
    assert json.loads(tuner_path.read_text()) == {"op_b": '{"tile": 256}'}
    # a fresh tuner reads the persisted winner without timing
    tuner2 = at.AutoTuner()
    assert tuner2.choose_one("op_b", R())["tile"] == 256
    assert tuner2.stats.cache_hits == 1 and tuner2.stats.profiled_tactics == 0
    # the default timer runs the runner on the CPU
    tuner2.enabled = True
    assert tuner2.choose_one("op_c", R())["tile"] in (128, 256, 512)


def _paged_case():
    from flashinfer_tpu_torch.ops.attention.batch import (
        BatchPrefillWithPagedKVCacheWrapper,
    )

    rng = np.random.default_rng(1)
    b, hq, hkv, d, ps = 2, 4, 2, 16, 8
    qo = np.array([40, 24])
    kv = qo + np.array([8, 0])
    pages = -(-kv // ps)
    indptr = np.concatenate([[0], np.cumsum(pages)])
    indices = rng.permutation(int(indptr[-1])).astype(np.int32)
    last = ((kv - 1) % ps) + 1
    q = torch.from_numpy(rng.standard_normal((int(qo.sum()), hq, d)).astype(
        np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal(
        (int(indptr[-1]), ps, hkv, d)).astype(np.float32)) for _ in range(2))

    def run():
        w = BatchPrefillWithPagedKVCacheWrapper(kv_layout="NHD", device="cpu")
        w.plan(np.concatenate([[0], np.cumsum(qo)]), indptr, indices, last,
               hq, hkv, d, ps, causal=True)
        return w, w.run(q, (kc, vc))
    return run


def _mla_case():
    from flashinfer_tpu_torch.ops.attention.mla import (
        BatchMLAPagedAttentionWrapper,
    )

    rng = np.random.default_rng(2)
    h, dc, dp, ps = 4, 32, 16, 8
    qo = np.array([24, 20])
    pages = -(-qo // ps)
    indptr = np.concatenate([[0], np.cumsum(pages)])
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    qn, qp = f(int(qo.sum()), h, dc), f(int(qo.sum()), h, dp)
    ckv, kpe = f(int(indptr[-1]), ps, dc), f(int(indptr[-1]), ps, dp)

    def run():
        w = BatchMLAPagedAttentionWrapper(device="cpu")
        w.plan(np.concatenate([[0], np.cumsum(qo)]), indptr,
               np.arange(int(indptr[-1]), dtype=np.int32), qo, h, dc, dp,
               ps, causal=True)
        return w, w.run(qn, qp, ckv, kpe)
    return run


@pytest.mark.parametrize("case,launch_mod,launch_fn", [
    ("paged", "flashinfer_tpu_torch.ops.attention.batch",
     "batch_paged_attention_run"),
    ("mla", "flashinfer_tpu_torch.ops.attention.mla", "mla_paged_run"),
])
def test_autotuner_drives_prefill_tiles(tuner_path, monkeypatch, case,
                                        launch_mod, launch_fn):
    """autotune() times the tile tactics at run() and persists a winner; a
    persisted winner then sets the tile_q a later plan launches with (the
    counterpart of JAX's test_autotuner_drives_attention_tiles)."""
    import importlib

    mod = importlib.import_module(launch_mod)
    seen = []
    real = getattr(mod, launch_fn)

    def spy(*a, **k):
        seen.append(k["tile_q"])
        return real(*a, **k)

    monkeypatch.setattr(mod, launch_fn, spy)
    run = {"paged": _paged_case, "mla": _mla_case}[case]()

    _, base = run()
    default = seen[-1]
    assert default >= 64  # the tensor-core prefill route

    with at.autotune():
        w, tuned = run()
    cfg = json.loads(tuner_path.read_text())
    (key, winner), = cfg.items()
    assert key.startswith(f"{case}_prefill_tile_q::")
    assert w.device_plan.meta.tile_q == json.loads(winner)["tile_q"]
    assert len(set(seen)) >= 2  # more than one tactic was launched

    # persist another tactic as the winner: the next plan launches with it
    alt = 128 if default != 128 else 64
    tuner_path.write_text(json.dumps({key: json.dumps({"tile_q": alt})}))
    monkeypatch.setattr(at.AutoTuner, "_instance", None)
    seen.clear()
    w, out = run()
    assert seen == [alt] and w.device_plan.meta.tile_q == alt
    np.testing.assert_allclose(out.numpy(), base.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tuned.numpy(), base.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_pinned_tile_q_is_not_tuned(tuner_path):
    from flashinfer_tpu_torch.ops.attention.batch import (
        BatchPrefillWithPagedKVCacheWrapper,
    )

    w = BatchPrefillWithPagedKVCacheWrapper(kv_layout="NHD", tile_q=256,
                                            device="cpu")
    with at.autotune():
        w.plan(np.array([0, 300]), np.array([0, 38]), np.arange(38),
               np.array([4]), 4, 4, 16, 8, causal=True)
        w.run(torch.zeros(300, 4, 16), (torch.zeros(38, 8, 4, 16),) * 2)
    assert w.device_plan.meta.tile_q == 256 and not tuner_path.exists()


def test_cli_list_ops_and_show_config(capsys):
    import flashinfer_tpu_torch
    from flashinfer_tpu_torch.__main__ import main

    assert main(["list-ops"]) == 0
    names = capsys.readouterr().out.split()
    assert names == sorted(flashinfer_tpu_torch.__all__)
    assert "BatchDecodeWithPagedKVCacheWrapper" in names
    assert main(["show-config"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["planner_backend"] == "auto"
    assert info["native_runtime_available"] is True
    assert info["torch_version"] == torch.__version__
    assert info["device"]["available"] == torch.cuda.is_available()
    assert main(["cache-status"]) == 0
    status = json.loads(capsys.readouterr().out)
    assert any(e["file"].startswith("fi_native-") for e in status["entries"])


def test_aot_warmup_small_on_the_cpu():
    from flashinfer_tpu_torch.aot import AotConfig, default_universe, warmup
    from flashinfer_tpu.aot import default_universe as jax_universe

    assert [c.name for c in default_universe()] == [
        c.name for c in jax_universe()]
    n = warmup(device="cpu", universe=[
        AotConfig(name="tiny_decode", op="decode", batch=2, kv_len=64,
                  num_qo_heads=4, num_kv_heads=2, head_dim=64,
                  page_size=16, dtype="float32"),
        AotConfig(name="tiny_ragged", op="ragged", batch=2, seq=16,
                  kv_len=32, num_qo_heads=4, num_kv_heads=2, head_dim=64,
                  dtype="float32"),
        AotConfig(name="sampling", op="sampling", batch=2),
        AotConfig(name="norm_rope_act", op="norm_rope_act", batch=2, seq=4,
                  head_dim=16),
    ])
    assert n == 4
    assert warmup(configs=["no_such_config"], device="cpu") == 0


def test_profiler_trace_on_the_cpu(tmp_path):
    from flashinfer_tpu_torch.profiler import (
        annotate,
        export_to_perfetto_trace,
        latest_trace_path,
        profile_trace,
        summarize_trace,
    )

    with profile_trace(str(tmp_path)) as d:
        with annotate("test_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = latest_trace_path(d)
    assert path is not None and path.endswith(".trace.json")
    events = json.loads(open(path).read())["traceEvents"]
    assert any(e.get("name") == "test_span" for e in events)
    assert summarize_trace(d) == []  # no device events on the CPU
    out = export_to_perfetto_trace(d, str(tmp_path / "copy.json"))
    assert json.loads(open(out).read())["traceEvents"]
    with pytest.raises(FileNotFoundError):
        summarize_trace(str(tmp_path / "empty"))


def test_utils_leftovers_equal_jax():
    assert utils.round_down(37, 8) == jax_utils.round_down(37, 8) == 32
    for name in ("bfloat16", "float32", "float8_e4m3fn", "float8_e5m2",
                 "int8"):
        jd = jnp.dtype(name)
        td = utils.canonicalize_dtype(name)
        assert utils.canonicalize_dtype(jd) is td
        assert utils.is_float8(td) == jax_utils.is_float8(jd)
        assert str(utils.get_compute_dtype(td)).split(".")[-1] == \
            jax_utils.get_compute_dtype(jd).name
    rng = np.random.default_rng(3)
    kv = rng.standard_normal((5, 2, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        utils.expand_gqa(torch.from_numpy(kv), 6).numpy(),
        np.asarray(jax_utils.expand_gqa(jnp.asarray(kv), 6)))
    np.testing.assert_array_equal(
        utils.pad_to(torch.from_numpy(kv), 9, 0, value=-1).numpy(),
        np.asarray(jax_utils.pad_to(jnp.asarray(kv), 9, 0, value=-1)))
    for qo, kvl, win in ((4, 10, 3), (10, 10, 0), (3, 7, -1), (1, 9, 5)):
        np.testing.assert_array_equal(
            utils.get_sliding_window_mask(qo, kvl, win).numpy(),
            np.asarray(jax_utils.get_sliding_window_mask(qo, kvl, win)))
    with pytest.raises(ValueError):
        utils.expand_gqa(torch.from_numpy(kv), 5)
