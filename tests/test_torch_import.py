"""The port stands alone: ``apex_tpu_torch`` (and ``chip_smoke.py``)
import neither ``jax`` nor anything of ``apex_tpu``, and an entry point
asked for nothing runs on the card — on a machine without one it raises
instead of quietly running on the CPU."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "apex_tpu_torch"


def _submodules():
    names = ["apex_tpu_torch"]
    for info in pkgutil.walk_packages([str(PORT)], "apex_tpu_torch."):
        names.append(info.name)
    return names


def test_import_pulls_in_no_jax():
    names = _submodules()
    assert {"apex_tpu_torch.serving.engine",
            "apex_tpu_torch.serving.supervisor",
            "apex_tpu_torch.testing_faults", "apex_tpu_torch.utils.prng",
            "apex_tpu_torch.utils.logging", "apex_tpu_torch.amp.scaler",
            "apex_tpu_torch.amp.policy", "apex_tpu_torch.fp16_utils",
            "apex_tpu_torch.multi_tensor_apply.multi_tensor_apply",
            "apex_tpu_torch.ops.multi_tensor", "apex_tpu_torch.parallel.larc",
            "apex_tpu_torch.utils.tree"} <= set(names)
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'apex_tpu' or "
            "m.startswith('apex_tpu.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_names_no_jax_module(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "apex_tpu")]
    assert not bad, f"{path}: {bad}"


def test_entry_points_default_to_the_card(monkeypatch):
    import torch

    from apex_tpu_torch.models import GPTModel, TransformerConfig
    from apex_tpu_torch.serving import InferenceEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(num_layers=1, hidden_size=32,
                            num_attention_heads=2, vocab_size=64,
                            max_position_embeddings=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTModel(cfg)
    model = GPTModel(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(model)
