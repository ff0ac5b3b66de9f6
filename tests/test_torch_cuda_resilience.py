"""Checkpoint and resilience on the card, at a tiny size: a 2-layer f32
GPT (TF32 off) under ``run_training`` resumes from an injected
preemption to the uninterrupted run's end state bit for bit, and a bf16
(and f32, int32, bool) snapshot of CUDA tensors round-trips through the
sharded format bit for bit, NaN and inf patterns included, synchronously
and on the async writer. Every test carries the ``cuda`` marker and
skips without a CUDA device; run them on a machine with one (the
repository's ``tests/conftest.py`` imports JAX, which that machine lacks):

    python -m pytest --noconftest tests/test_torch_cuda_resilience.py -q
"""

import pytest
import torch

from apex_tpu_torch import resilience
from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.checkpoint import (RetryingCheckpointManager,
                                       ShardedCheckpointManager)
from apex_tpu_torch.models import GPTModel, TransformerConfig
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.testing_faults import FaultInjector

pytestmark = pytest.mark.cuda

TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64, hidden_dropout=0.0,
            attention_dropout=0.0)


def _batch(step):
    g = torch.Generator().manual_seed(50 + step)
    return {"tokens": torch.randint(0, 128, (2, 32), generator=g).cuda(),
            "labels": torch.randint(0, 128, (2, 32), generator=g).cuda(),
            "loss_mask": torch.ones(2, 32, device="cuda")}


def _run(directory, faults=None):
    model = GPTModel(TransformerConfig(**TINY), device="cuda",
                     generator=torch.Generator().manual_seed(0))
    opt = FusedAdam(model.parameters(), lr=1e-3)
    scaler = LossScaler("dynamic")
    step = resilience.make_resilient_train_step(
        lambda b, r: model(b["tokens"], b["labels"],
                           loss_mask=b["loss_mask"]), opt, scaler)
    state = resilience.make_train_state(model, opt, scaler.init())
    cfg = resilience.ResilienceConfig(
        save_interval_steps=4, poll_interval_steps=4,
        max_consecutive_skips=2, max_to_keep=3, handle_sigterm=False)
    return resilience.run_training(step, state, _batch, 12,
                                   checkpoint_dir=str(directory), config=cfg,
                                   fault_injector=faults)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_card_resume_is_bitwise_the_uninterrupted_run(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    clean = _run(tmp_path / "clean")
    first = _run(tmp_path / "run", FaultInjector(nan_grad_calls={5, 6},
                                                 preempt_at_call=9))
    assert first.status == "preempted" and first.rollbacks == 1
    resumed = _run(tmp_path / "run")
    assert resumed.telemetry["resumes"] == 1
    assert resumed.status == clean.status == "completed"
    for (key, a), (_, b) in zip(
            sorted(_items(clean.state)), sorted(_items(resumed.state))):
        assert torch.equal(a, b), key


def _items(state):
    from apex_tpu_torch.checkpoint.sharded import tree_items
    return [(k, v) for k, v in tree_items(state)
            if not k.startswith("['scaler']")]


def test_bf16_snapshot_round_trips_bitwise_from_cuda(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    bits = torch.randint(-2 ** 15, 2 ** 15, (257, 129), generator=g,
                         device="cuda", dtype=torch.int32).to(torch.int16)
    bits[0, :4] = torch.tensor([0x7FC0, 0x7F80, -0x80, 1], device="cuda",
                               dtype=torch.int16)     # NaN, inf, -inf, tiny
    live = {"b16": bits.view(torch.bfloat16),
            "f32": torch.randn(33, 7, generator=g, device="cuda"),
            "step": torch.tensor(7, dtype=torch.int32, device="cuda"),
            "flag": torch.tensor([True, False], device="cuda")}
    want = {k: v.clone() for k, v in live.items()}
    for asynchronous in (False, True):
        base = ShardedCheckpointManager(str(tmp_path / str(asynchronous)))
        mgr = RetryingCheckpointManager(base, async_writes=asynchronous)
        assert mgr.save(7, live)
        for t in live.values():      # in place after the snapshot
            t.zero_()
        mgr.wait_until_finished()
        step, got = mgr.restore_latest(live)
        assert step == 7 and got is live
        for k, v in want.items():
            assert live[k].device.type == "cuda"
            assert torch.equal(_bits(live[k]), _bits(v)), k
        mgr.close()
