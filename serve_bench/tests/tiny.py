"""A benchmark tree at tiny sizes for CPU tests: its own BENCHMARK.json, a
tiny configuration, two cells and their mixes, and the real metrics."""

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

TINY_CONFIG = {
    "hidden_act": "silu", "hidden_size": 128, "intermediate_size": 256,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
    "num_hidden_layers": 2, "vocab_size": 256, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-5, "sliding_window": None,
    "tie_word_embeddings": False,
}
ENGINE = {"max_batch": 8, "num_pages": 256, "page_size": 16,
          "max_seq_len": 256, "top_k": 40, "top_p": 0.9,
          "temperature": 1.0, "greedy": False, "kv_dtype": "model",
          "kv_layout": "NHD", "decode_window": 1, "cuda_graphs": True}


def make_tree(tmp: Path) -> Path:
    """A root with BENCHMARK.json and a bench folder ``sb`` beside it."""
    sb = tmp / "sb"
    for d in ("configs", "workloads", "traffic"):
        (sb / d).mkdir(parents=True)
    shutil.copytree(BENCH / "metrics", sb / "metrics")
    shutil.copytree(BENCH / "arrivals", sb / "arrivals")
    (sb / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    (sb / "traffic" / "chat.json").write_text(json.dumps({
        "arrivals": "poisson", "order_seed": 1,
        "prompt": {"dist": "lognormal", "median": 40, "sigma": 0.8,
                   "min": 16, "max": 160},
        "output": {"dist": "lognormal", "median": 10, "sigma": 0.7,
                   "min": 4, "max": 48}}))
    (sb / "traffic" / "closed.json").write_text(json.dumps({
        "arrivals": "closed", "sessions": 4, "order_seed": 2,
        "prompt": {"dist": "uniform", "min": 64, "max": 160},
        "output": {"dist": "fill"}}))
    check = {"min_tokens": 40, "max_requests": 4, "served_gap": 0.5}
    (sb / "workloads" / "tiny.chat.json").write_text(json.dumps({
        "engine": ENGINE, "rate_per_s": 6.0, "check": check,
        "warmup": {"prefill_rows_max": 256, "decode_chunk": 32,
                   "decode_items_max": 32, "min_s": 0.2, "max_s": 1.0,
                   "quiet_s": 0.1}}))
    (sb / "workloads" / "tiny.closed.json").write_text(json.dumps({
        "engine": ENGINE, "check": check,
        "warmup": {"prefill_rows_max": 256, "min_s": 0.2, "max_s": 1.0,
                   "quiet_s": 0.1}}))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny", "source": "test",
                        "file": "sb/configs/tiny.json", "reduced": [],
                        "why": "test"}]
    spec["workloads"] = [
        {"name": "tiny.chat", "config": "tiny", "traffic": "chat",
         "chips": 1, "why": "test"},
        {"name": "tiny.closed", "config": "tiny", "traffic": "closed",
         "chips": 1, "why": "test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = (["tiny.chat"] if m["name"] in
                              ("ttft_p95_ms", "prefill_step_ms")
                              else ["tiny.chat", "tiny.closed"])
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return sb
