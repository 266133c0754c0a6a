"""The benchmark's arithmetic, generator, registry and guards, on the CPU."""

import json
import types

import numpy as np
import pytest

from serve_bench import check, stats, traffic
from serve_bench.model import ModelShape, bound_s
from serve_bench.run import forbidden_modules
from serve_bench.serve import ttft_samples
from serve_bench.registry import Registry
from serve_bench.trace import family, read_chrome_trace

from tiny import BENCH, make_tree

CHAT = json.loads((BENCH / "traffic" / "chat.json").read_text())
CLOSED = json.loads((BENCH / "traffic" / "longctx_decode.json").read_text())


@pytest.mark.parametrize("mix", [CHAT, CLOSED], ids=["chat", "closed"])
def test_traffic_repeats_from_a_seed(mix):
    a = traffic.make_requests(mix, 2**31 + 77, 30.0, 8.0, 32768, 16384)
    b = traffic.make_requests(mix, 2**31 + 77, 30.0, 8.0, 32768, 16384)
    c = traffic.make_requests(mix, 5, 30.0, 8.0, 32768, 16384)
    assert [(r.due_s, r.prompt.tolist(), r.max_new_tokens) for r in a] == \
        [(r.due_s, r.prompt.tolist(), r.max_new_tokens) for r in b]
    # another seed: the mix's own order of sizes and gaps, other token ids
    assert [(r.due_s, len(r.prompt), r.max_new_tokens) for r in a] == \
        [(r.due_s, len(r.prompt), r.max_new_tokens) for r in c]
    assert a[0].prompt.tolist() != c[0].prompt.tolist()
    # the warm-up's order is another one
    w = traffic.make_requests(mix, 5, 30.0, 8.0, 32768, 16384, "warmup")
    if len(w) > 1:
        assert [len(r.prompt) for r in w] != [len(r.prompt) for r in c]
    # another order seed: the same multiset in another order
    other = dict(mix, order_seed=mix["order_seed"] + 1)
    d = traffic.make_requests(other, 5, 30.0, 8.0, 32768, 16384)
    assert sorted(len(r.prompt) for r in d) == sorted(len(r.prompt) for r in c)
    assert [len(r.prompt) for r in d] != [len(r.prompt) for r in c]
    # a mix without its order is refused
    free = {k: v for k, v in mix.items() if k != "order_seed"}
    with pytest.raises(KeyError):
        traffic.make_requests(free, 5, 30.0, 8.0, 32768, 16384)


def test_open_loop_offers_rate_times_seconds():
    reqs = traffic.make_requests(CHAT, 3, 40.0, 8.0, 32768, 4096)
    assert len(reqs) == 320
    due = [r.due_s for r in reqs]
    assert due == sorted(due) and 0 < due[0] and due[-1] == pytest.approx(40)
    lens = np.array([len(r.prompt) for r in reqs])
    assert lens.min() >= 32 and lens.max() <= 3072
    assert 400 < np.median(lens) < 640


def test_derived_seed_differs():
    assert traffic.derived_seed(7, "warmup") != 7
    assert traffic.derived_seed(7, "warmup") == traffic.derived_seed(7, "warmup")
    assert traffic.derived_seed(7, "warmup") != traffic.derived_seed(8, "warmup")


def test_p95_over_every_sample_and_waits_enter():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([5.0], 95) == 5.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)
    done = types.SimpleNamespace(due=1.0, first=1.2)
    waiting = types.SimpleNamespace(due=2.0, first=None)
    assert ttft_samples([done, waiting], 10.0) == pytest.approx([0.2, 8.0])
    assert stats.tail_pct(1000) == 99 and stats.tail_pct(9) == 100


def test_spread_is_iqr_over_median():
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def test_idle_union_over_overlapping_intervals():
    ivs = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 8)]
    assert stats.union_length(ivs) == 4
    assert stats.gaps(ivs, 0, 10) == [(3, 5), (6, 10)]
    assert stats.gaps([], 0, 1) == [(0, 1)]


def _cfg(name):
    return ModelShape.from_config(json.loads(
        (BENCH / "configs" / f"{name}.json").read_text()))


def test_counts_of_mistral_7b_by_hand():
    m = _cfg("mistral-7b-v0.3")
    assert (m.head_dim, m.q_heads, m.kv_heads) == (128, 32, 8)
    # q 4096x4096, k and v 4096x1024 each, o 4096x4096, MLP 3 x 4096x14336
    layer = 4096 * 4096 * 2 + 4096 * 1024 * 2 + 3 * 4096 * 14336
    assert m.layer_weight_elems == layer
    assert m.params == 32 * (layer + 2 * 4096) + 2 * 4096 * 32768 + 4096
    assert 7.24e9 < m.params < 7.26e9
    assert m.weight_bytes() == 2 * (32 * layer + 4096 * 32768)
    assert m.matmul_flops(10, 2) == 2 * (10 * 32 * layer + 2 * 4096 * 32768)
    assert m.kv_bytes_per_token() == 128 * 1024  # 128 KB a token
    assert m.attn_flops(100) == 4 * 100 * 32 * 128 * 32
    assert m.qo_bytes(3) == 2 * 2 * 3 * 4096 * 32


def test_counts_of_mistral_small_24b_by_hand():
    m = _cfg("mistral-small-24b-2501")
    # q width 4096 under a hidden of 5120
    layer = 5120 * 4096 * 2 + 5120 * 1024 * 2 + 3 * 5120 * 32768
    assert m.layer_weight_elems == layer
    assert 23.5e9 < m.params < 23.7e9
    assert m.kv_bytes_per_token() == 160 * 1024  # 160 KB a token
    assert m.weight_bytes() == 2 * (40 * layer + 5120 * 131072)
    # a decode step bound by weight reads: 45.8 GB at 3.35 TB/s
    t = bound_s(m.matmul_flops(64, 64), m.weight_bytes())
    assert 0.0135 < t < 0.0139


def test_kept_floor_is_top_k_then_top_p():
    lg = torch_tensor([[5.0, 4.0, 3.0, 0.0, -1.0]])
    # top-2 then p 0.5: the first alone holds 0.73 of the top-2 mass
    assert check.kept_floor(lg, 2, 0.5, 1.0).item() == 5.0
    assert check.kept_floor(lg, 2, 0.9, 1.0).item() == 4.0
    assert check.kept_floor(lg, 4, 1.0, 1.0).item() == 0.0
    gap = check.served_gap([lg[0][None].repeat(2, 1)], [[0, 4]], 2, 0.9, 1.0)
    assert gap == pytest.approx(5.0)  # token 4 (logit -1) under floor 4
    assert check.served_gap([lg], [[1]], 2, 0.9, 1.0) == 0.0


def torch_tensor(x):
    import torch

    return torch.tensor(x)


def test_pick_sample_keeps_the_longest():
    reqs = [types.SimpleNamespace(prompt=[0] * p, output=[1] * o, done=True)
            for p, o in ((10, 5), (300, 40), (20, 30), (50, 50))]
    pick = check.pick_sample(reqs, 3, 60, 8)
    assert pick[0] == 1 and sum(len(reqs[i].output) for i in pick) >= 60
    assert pick == check.pick_sample(reqs, 3, 60, 8)


def test_registry_finds_what_is_added_as_files(tmp_path):
    sb = make_tree(tmp_path)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    # a new configuration, cell, traffic mix and metric: files and entries
    (sb / "configs" / "other.json").write_text(json.dumps(
        dict(json.loads((sb / "configs" / "tiny.json").read_text()),
             num_hidden_layers=3)))
    (sb / "traffic" / "burst.json").write_text(json.dumps(
        {"arrivals": "steady", "order_seed": 3, "prompt": CHAT["prompt"],
         "output": CHAT["output"]}))
    (sb / "arrivals" / "steady.py").write_text(
        "import numpy as np\n\n\n"
        "def due_times(mix, seconds, rate, rng):\n"
        "    n = int(rate * seconds)\n"
        "    return (np.arange(n) + 1) * seconds / n\n")
    (sb / "workloads" / "other.burst.json").write_text(json.dumps(
        {"engine": {}, "rate_per_s": 1.0}))
    (sb / "metrics" / "answer.py").write_text(
        "def read(run):\n    return 42.0\n")
    spec["configs"].append({"name": "other", "source": "test",
                            "file": "sb/configs/other.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "other.burst", "config": "other",
                              "traffic": "burst", "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "answer", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "setup_s",
                              "workloads": ["other.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    reg = Registry(tmp_path, sb)
    assert reg.config("other")["num_hidden_layers"] == 3
    assert reg.cell("other.burst")["rate_per_s"] == 1.0
    mix = reg.traffic(reg.workload("other.burst")["traffic"])
    reqs = traffic.make_requests(mix, 1, 4.0, 2.0, 256, 4096, bench_dir=sb)
    assert [r.due_s for r in reqs] == [0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0]
    names = [m["name"] for m in reg.metrics_of("per_layer", "other.burst")]
    assert names == ["answer"]
    assert reg.metric("answer").read(None) == 42.0
    assert "answer" not in [m["name"]
                            for m in reg.metrics_of("per_layer", "tiny.chat")]


def test_import_check_compares_whole_top_level_names():
    assert forbidden_modules(["jax", "jax.numpy", "numpy"]) == \
        ["jax", "jax.numpy"]
    assert forbidden_modules(["flashinfer_tpu.ops"]) == ["flashinfer_tpu.ops"]
    assert forbidden_modules(["flashinfer_tpu_torch", "flashinfer_tpu_torch.ops",
                              "jaxtyping", "flaxen", "benchmark_utils"]) == []


def test_benchmark_sources_import_no_jax():
    """No file of the benchmark names a forbidden module in an import."""
    import ast

    for path in BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            assert forbidden_modules(names) == [], (path, names)


def test_kernel_families():
    assert family("void paged_dec_kernel<128>(Params)") == "paged_attention"
    assert family("sm90_xmma_gemm_bf16bf16_bf16f32") == "matmul"
    assert family("nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NTN") == "matmul"
    assert family("family_cluster_kernel") == "sampler_family"
    assert family("rmsnorm_kernel<1>") == "rmsnorm"
    assert family("gpu_memcpy") == "copies"
    assert family("elementwise_kernel") == "other"


def test_chrome_trace_reader(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.slice",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.step",
         "ts": 0, "dur": 60},
        {"ph": "X", "cat": "user_annotation", "name": "bench.bookkeeping",
         "ts": 60, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "paged_dec_kernel",
         "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "nvjet_gemm", "ts": 20,
         "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 95,
         "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 5},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    sl = read_chrome_trace(path)
    assert sl.wall_s == pytest.approx(100e-6)
    assert sl.busy_s == pytest.approx(35e-6)  # 10-40 and 95-100
    assert sl.by_family == pytest.approx({"paged_attention": 20e-6,
                                          "matmul": 20e-6, "copies": 5e-6})
    # idle: 0-10 and 40-60 in the step, 60-90 bookkeeping, 90-95 neither
    assert sl.idle_by_span == pytest.approx({
        "bench.step": 30e-6, "bench.bookkeeping": 30e-6,
        "bench.slice": 5e-6})
