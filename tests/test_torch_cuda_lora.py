"""Multi-LoRA serving on the card against the CPU, at a tiny size: a
2-layer f32 GPT (TF32 off) with two adapters in an ``AdapterStore`` on
each device serves the same tenant and base requests, greedy and sampled,
on the paged layout, with ``speculation=3`` and with chunked prefill; the
card's tokens equal the CPU's, and the card's fine-tuning losses the
CPU's within 1e-4 relative. Every test carries the ``cuda`` marker and
skips without a CUDA device; run them on a machine with one (the
repository's ``tests/conftest.py`` imports JAX, which that machine lacks):

    python -m pytest --noconftest tests/test_torch_cuda_lora.py -q
"""

import pytest
import torch

from apex_tpu_torch.lora import AdapterStore, lora_finetune, random_adapter
from apex_tpu_torch.models import GPTModel, TransformerConfig
from apex_tpu_torch.serving import (EngineConfig, InferenceEngine, Request,
                                    SamplingParams)

pytestmark = pytest.mark.cuda

TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64, hidden_dropout=0.0,
            attention_dropout=0.0)


def _requests():
    g = torch.Generator().manual_seed(3)
    out = []
    for i, aid in enumerate(("a", "b", None, "a", "b", None)):
        prompt = torch.randint(0, 128, (4 + 5 * i,), generator=g).tolist()
        sp = SamplingParams(adapter_id=aid)
        if i >= 3:
            sp = SamplingParams(adapter_id=aid, temperature=0.9, top_k=16,
                                seed=7 + i)
        out.append(Request(prompt=prompt, max_new_tokens=8, sampling=sp))
    return out


def _serve(device, knobs):
    model = GPTModel(TransformerConfig(**TINY), device=device,
                     generator=torch.Generator().manual_seed(0))
    store = AdapterStore(model.config, 4, max_adapters=3, device=device)
    g = torch.Generator().manual_seed(1)
    for aid in ("a", "b"):
        store.load(aid, random_adapter(model.config, 4, g, 0.2,
                                       device=device))
    engine = InferenceEngine(model, EngineConfig(
        max_slots=4, max_len=64, page_size=8, **knobs), adapters=store,
        device=device)
    return [r.tokens for r in engine.serve(_requests())]


@pytest.mark.parametrize("knobs", [{}, {"speculation": 3},
                                   {"prefill_token_budget": 8}],
                         ids=["paged", "spec", "chunked"])
def test_card_engine_with_adapters_matches_cpu(knobs, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    assert _serve("cuda", knobs) == _serve("cpu", knobs)


def test_card_finetune_matches_cpu(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, 128, (2, 2, 16), generator=g)
    labels = torch.randint(0, 128, (2, 2, 16), generator=g)
    losses = {}
    for device in ("cuda", "cpu"):
        model = GPTModel(TransformerConfig(**TINY), device=device,
                         generator=torch.Generator().manual_seed(0))
        _, losses[device] = lora_finetune(
            model, tokens, labels, rank=4, steps=5, lr=1e-2,
            generator=torch.Generator().manual_seed(2))
    card, cpu = losses["cuda"].cpu(), losses["cpu"]
    assert bool(((card - cpu).abs() <= 1e-4 * cpu.abs()).all())
    assert bool((card[-1] < card[0]).all())
