"""Flash attention forward of the port against the JAX package.

Numpy-made q/k/v go through ``apex_tpu.ops.flash_attention`` (its plain
path, and the Pallas kernels in interpret mode: a multi-block shape,
s=160 with 64-row blocks, and a single-block shape) and through
``apex_tpu_torch.ops.flash_attention`` on the CPU (the plain version of
the Hopper kernel). Cases: causal and not, GQA (8 heads over 2 groups),
``kv_lengths`` (one of them 0: a batch row with no visible key),
``sliding_window``, ``sq != sk``, head_dim 64.

Tolerance: f32 atol 2e-5 — both compute softmax in fp32; the flash
kernels sum in another order than one softmax over the row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import _support as jax_support
from apex_tpu.ops import flash_attention as jax_flash
from apex_tpu_torch.ops import flash_attention

CASES = {
    # name: (b, h, kvh, sq, sk, d, causal, kv_lengths, window)
    "causal": (2, 4, 4, 96, 96, 64, True, None, None),
    "full": (2, 4, 4, 96, 96, 64, False, None, None),
    "gqa_8_over_2": (1, 8, 2, 80, 80, 64, True, None, None),
    "kv_lengths": (3, 4, 4, 64, 64, 64, False, [64, 17, 0], None),
    "causal_kv_lengths": (2, 4, 2, 72, 72, 64, True, [40, 72], None),
    "sliding_window": (1, 4, 4, 128, 128, 64, True, None, 24),
    "sq_lt_sk_causal": (2, 4, 4, 24, 100, 64, True, None, None),
    "sq_lt_sk_window": (1, 8, 2, 33, 90, 64, True, [70], 16),
    "head_dim_32": (1, 2, 1, 50, 70, 32, False, None, None),
}


@pytest.fixture
def jax_mode(monkeypatch):
    def set_mode(mode):
        monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", mode)
        jax_support.pallas_mode.cache_clear()
    yield set_mode
    jax_support.pallas_mode.cache_clear()


def _run(case, seed=0, **blocks):
    b, h, kvh, sq, sk, d, causal, kvl, window = case
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, kvh, sk, d).astype(np.float32)
    v = rng.randn(b, kvh, sk, d).astype(np.float32)
    kvl = None if kvl is None else np.asarray(kvl, np.int32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, sliding_window=window,
                     kv_lengths=None if kvl is None else jnp.asarray(kvl),
                     **blocks)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal,
                          sliding_window=window,
                          kv_lengths=None if kvl is None
                          else torch.from_numpy(kvl))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax_plain(jax_mode, name):
    jax_mode("off")
    want, got = _run(CASES[name])
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("case,blocks", [
    # multi-block: s=160 over 64-row tiles (causal, GQA, varlen)
    ((1, 8, 2, 160, 160, 64, True, [150], None),
     dict(block_q=64, block_k=64)),
    # multi-block with a sliding window (banded grid)
    ((1, 4, 4, 160, 160, 64, True, None, 40), dict(block_q=64, block_k=64)),
    # single-block: the whole problem is one (bq, bk) tile
    ((2, 4, 4, 48, 48, 64, True, None, None), {}),
])
def test_forward_matches_jax_interpret_kernel(jax_mode, case, blocks):
    jax_mode("interpret")
    want, got = _run(case, seed=1, **blocks)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_fully_masked_row_is_zero():
    _, got = _run(CASES["kv_lengths"])
    assert not np.any(got[2])


def test_bf16_output_keeps_input_dtype():
    q = torch.randn(1, 2, 8, 64, dtype=torch.bfloat16)
    assert flash_attention(q, q, q, causal=True).dtype == torch.bfloat16


def test_invalid_arguments_raise():
    q = torch.zeros(1, 4, 8, 64)
    with pytest.raises(ValueError, match="kv_heads"):
        flash_attention(q, torch.zeros(1, 3, 8, 64), torch.zeros(1, 3, 8, 64))
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, q, q, sliding_window=4)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q.requires_grad_(), q, q)
