#!/usr/bin/env python3
"""The PyTorch operations the serving engine dispatches in one tick, as a
count and a sha256 digest of their names, so two checkouts can be shown
to run the same operations.

Usage (on the CPU, with the checkout to read first on the path)::

    PYTHONPATH=DIR python3 DIR/apex_tpu_torch/tools/tick_ops.py [--adapters]

A tiny f32 GPT (2 layers, hidden 64, 4 heads) on the CPU admits 8
requests, half of them sampled, into an engine of 8 slots under each
configuration (paged, ``speculation=3``, the flat layout, chunked prefill
at a budget of 16); the tool records every ATen operation of the first
tick (the prefills, or the first chunks) and of one decode-only tick with
a ``TorchDispatchMode`` and prints one JSON line a configuration. With
``--adapters`` the engine holds an ``AdapterStore`` and every request one
of its two adapters, which shows the operations the per-slot deltas add.
"""

from __future__ import annotations

import argparse
import hashlib
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu_torch.models import GPTModel, TransformerConfig
from apex_tpu_torch.serving import (EngineConfig, InferenceEngine, Request,
                                    SamplingParams)

CONFIGS = {"paged": {}, "spec": {"speculation": 3},
           "flat": {"kv_layout": "flat"},
           "chunked": {"prefill_token_budget": 16}}


class _Record(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _summary(ops) -> dict:
    return {"ops": len(ops), "sha256": hashlib.sha256(
        "\n".join(ops).encode()).hexdigest()[:16]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--adapters", action="store_true",
                        help="serve every request under one of two "
                        "adapters of an AdapterStore")
    args = parser.parse_args()
    cfg = TransformerConfig(num_layers=2, hidden_size=64,
                            num_attention_heads=4, vocab_size=128,
                            max_position_embeddings=128, hidden_dropout=0.0,
                            attention_dropout=0.0)
    model = GPTModel(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    store = None
    if args.adapters:
        from apex_tpu_torch.lora import AdapterStore, random_adapter
        store = AdapterStore(cfg, 4, max_adapters=2, device="cpu")
        for aid in ("a", "b"):
            store.load(aid, random_adapter(
                cfg, 4, torch.Generator().manual_seed(len(aid)),
                device="cpu"))
    for name, knobs in CONFIGS.items():
        g = torch.Generator().manual_seed(1)
        engine = InferenceEngine(model, EngineConfig(
            max_slots=8, max_len=128, page_size=16, **knobs),
            adapters=store, device="cpu")
        for i in range(8):
            engine.submit(Request(
                prompt=torch.randint(0, 128, (10 + 7 * i,),
                                     generator=g).tolist(),
                max_new_tokens=30, sampling=SamplingParams(
                    temperature=0.8 * (i % 2), seed=i,
                    adapter_id="ab"[i % 2] if store else None)))
        first = _Record()
        with first:
            engine.tick()
        while engine.queued_count or engine._prefilling:
            engine.tick()
        engine.tick()
        decode = _Record()
        with decode:
            engine.tick()
        print(json.dumps({"config": name, "adapters": bool(store),
                          "first_tick": _summary(first.ops),
                          "decode_tick": _summary(decode.ops)}),
              flush=True)


if __name__ == "__main__":
    main()
