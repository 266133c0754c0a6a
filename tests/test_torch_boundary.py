"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "flashinfer_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flashinfer_tpu")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import flashinfer_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = sorted(set(sys.modules) - before)\n"
        "print('\\n'.join(new))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = out.split()
    assert "flashinfer_tpu_torch.serving.engine" in loaded
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno)


def test_engine_default_device_needs_cuda(monkeypatch):
    from flashinfer_tpu_torch import EngineConfig, LlamaConfig, \
        LlamaServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EngineConfig(model=LlamaConfig.tiny())
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaServingEngine(cfg)


def test_wrappers_default_to_cuda(monkeypatch):
    from flashinfer_tpu_torch.models.llama import llama_init_weights
    from flashinfer_tpu_torch.ops.attention.batch import BatchAttention

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchAttention()
    from flashinfer_tpu_torch import PODWithPagedKVCacheWrapper

    with pytest.raises(RuntimeError, match="CUDA"):
        PODWithPagedKVCacheWrapper()
    from flashinfer_tpu_torch import LlamaConfig

    with pytest.raises(RuntimeError, match="CUDA"):
        llama_init_weights(torch.Generator(), LlamaConfig.tiny())


def test_deepseek_entry_points_default_to_cuda(monkeypatch):
    from flashinfer_tpu_torch.models.deepseek import (
        DeepSeekConfig,
        deepseek_init_weights,
        params_from_numpy,
    )
    from flashinfer_tpu_torch.ops.attention.mla import (
        BatchMLAPagedAttentionWrapper,
    )
    from flashinfer_tpu_torch.ops.rope import rope_cos_sin_cache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchMLAPagedAttentionWrapper()
    with pytest.raises(RuntimeError, match="CUDA"):
        deepseek_init_weights(torch.Generator(), DeepSeekConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({})
    with pytest.raises(RuntimeError, match="CUDA"):
        rope_cos_sin_cache(8, 16)


def test_chip_smoke_fails_without_the_card(tmp_path):
    """Without a card, and alone in a directory, the script exits non-zero
    and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    runs = [(tmp_path, tmp_path / "chip_smoke.py")]
    if not torch.cuda.is_available():
        runs.append((ROOT, ROOT / "chip_smoke.py"))
    for cwd, script in runs:
        run = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert run.returncode != 0
        assert '"ok"' not in run.stdout
