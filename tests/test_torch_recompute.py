"""Activation recompute and the chunked LM-head loss in the port, on the
CPU, against the port without them and against the JAX package.

``recompute=True``/``'full'`` runs each layer under
``torch.utils.checkpoint``; ``'selective'`` saves the outputs of the
non-batched matmuls (``aten.mm``/``aten.addmm``) and recomputes the rest,
the attention kernels' plain versions included (JAX's
``dots_with_no_batch_dims_saveable``). Every dropout key is explicit, so
the recompute draws the forward's masks. Held here, with dropout 0.1 on:

- a tiny GPT (the packed attention's hash dropout), a tiny BERT with a
  padding mask (the masked softmax and its dropout) and a tiny
  encoder-decoder with ``enc_lengths`` (the decoder's checkpointed layers
  carry the encoder output's gradient): under every recompute mode the
  loss and EVERY gradient BITWISE equal to no recompute;
- ``loss_seq_chunks`` 2 and 4: the loss bitwise the unchunked one and
  every gradient but the tied word embedding's bitwise too (its head
  part sums over the chunks in another order: within 1e-6 of its largest
  magnitude); a count that does not divide the sequence is skipped, as
  in JAX;
- ``'selective'`` keeps the matmul outputs: its backward runs no more
  matmuls than one without recompute, ``'full'`` four more a layer;
- in the slow test (each JAX compile costs seconds): the GPT's loss and
  gradients without recompute, and with ``recompute`` full and selective
  and ``loss_seq_chunks`` 2 and 4, against the JAX model's with the same
  knobs and key (loss rtol 1e-5, each leaf atol 1e-5 of its largest
  magnitude, as ``test_torch_gpt_training.py``); ``test_torch_dropout.py``
  holds a dropout GPT to JAX in tier 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.ops import _support as jax_support
from apex_tpu_torch.convert import grads_to_jax, params_to_jax
from apex_tpu_torch.models import (
    BertModel,
    EncoderDecoderModel,
    GPTModel,
    TransformerConfig,
)
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.utils import prng

TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64, hidden_dropout=0.1,
            attention_dropout=0.1)
BATCH, SEQ, KEY = 2, 32, 9
MODES = [True, "full", "selective"]


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: with several, the CPU GEMMs may sum in another
    order from run to run (the tied embedding's gradient moves by an ulp),
    which no bitwise comparison of two runs survives."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(kind):
    rng = np.random.RandomState(4)
    v = TINY["vocab_size"]
    if kind == "gpt":
        return tuple(rng.randint(0, v, (BATCH, SEQ)).astype(np.int32)
                     for _ in range(2))
    if kind == "bert":
        tokens, labels = (rng.randint(0, v, (BATCH, SEQ)).astype(np.int32)
                          for _ in range(2))
        padding = np.ones((BATCH, SEQ), bool)
        padding[0, 21:] = False
        return tokens, padding, np.zeros((BATCH, SEQ), np.int32), labels
    enc, dec, labels = (rng.randint(0, v, (BATCH, n)).astype(np.int32)
                        for n in (SEQ, 16, 16))
    return enc, dec, labels, np.array([SEQ, 13], np.int32)


def _run(kind, **knobs):
    """The port's loss and gradients with dropout on (key ``KEY``)."""
    gen = torch.Generator().manual_seed(6)
    tb = [torch.from_numpy(a) for a in _batch(kind)]
    tb = [t if t.dtype == torch.bool else t.long() for t in tb]
    key = prng.prng_key(KEY)
    if kind == "gpt":
        tm = GPTModel(TransformerConfig(**TINY, **knobs), device="cpu",
                      generator=gen)
        loss = tm(*tb, rng=key, deterministic=False)
    elif kind == "bert":
        tm = BertModel(TransformerConfig(
            **TINY, **knobs, attn_mask_type=AttnMaskType.padding),
            device="cpu", generator=gen)
        loss = tm(*tb, rng=key, deterministic=False)[0]
    else:
        tm = EncoderDecoderModel(TransformerConfig(
            **TINY, **knobs, normalization="rmsnorm", activation="relu"),
            device="cpu", generator=gen)
        loss = tm(tb[0], tb[1], tb[2], enc_lengths=tb[3], rng=key,
                  deterministic=False)
    loss.backward()
    return tm, loss.detach(), {n: p.grad.clone()
                               for n, p in tm.named_parameters()
                               if p.grad is not None}


@functools.lru_cache(maxsize=None)
def _reference(kind):
    return _run(kind)[1:]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["gpt", "bert", "enc_dec"])
def test_recompute_grads_are_bitwise_no_recompute(kind, mode):
    loss0, grads0 = _reference(kind)
    _, loss, grads = _run(kind, recompute=mode)
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys()
    for name, g in grads.items():
        assert torch.equal(g, grads0[name]), name


@pytest.mark.parametrize("chunks", [2, 4, 5])
def test_chunked_loss_matches_the_unchunked(chunks):
    """5 does not divide the 32 positions: the loss runs unchunked."""
    loss0, grads0 = _reference("gpt")
    _, loss, grads = _run("gpt", loss_seq_chunks=chunks)
    assert torch.equal(loss, loss0)
    tied = "embedding.word_embeddings.weight"
    for name, g in grads.items():
        if name == tied and chunks != 5:
            w = grads0[name]
            torch.testing.assert_close(g, w, rtol=0,
                                       atol=1e-6 * float(w.abs().max()))
        else:
            assert torch.equal(g, grads0[name]), name


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in (torch.ops.aten.mm.default,
                           torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


def test_selective_recompute_saves_the_matmuls():
    """The backward of ``'selective'`` runs no more matmuls than that of no
    recompute (their outputs are saved), ``'full'`` runs each layer's
    projections again."""
    counts = {}
    for mode in (False, "full", "selective"):
        tm = GPTModel(TransformerConfig(**TINY, recompute=mode),
                      device="cpu", generator=torch.Generator().manual_seed(6))
        tokens, labels = (torch.from_numpy(a).long() for a in _batch("gpt"))
        loss = tm(tokens, labels, rng=prng.prng_key(KEY), deterministic=False)
        with _CountMatmuls() as count:
            loss.backward()
        counts[mode] = count.n
    # per layer: the QKV, output, and two MLP projections
    assert counts["selective"] == counts[False]
    assert counts["full"] == counts[False] + 4 * TINY["num_layers"]


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(knobs):
    jm = JaxGPT(JaxConfig(**TINY, **dict(knobs)))
    return jax.jit(jax.value_and_grad(
        lambda p, tok, lab, k: jm.apply(p, tok, lab, rng=k,
                                        deterministic=False)))


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _check_against_jax(**knobs):
    tm, loss, _ = _run("gpt", **knobs)
    params = jax.tree.map(jnp.asarray, params_to_jax(tm.state_dict()))
    tokens, labels = (jnp.asarray(a) for a in _batch("gpt"))
    jloss, jgrads = _jax_loss_and_grad(tuple(sorted(knobs.items())))(
        params, tokens, labels, jax.random.PRNGKey(KEY))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want, got = _leaves(jgrads), _leaves(grads_to_jax(tm))
    assert want.keys() == got.keys()
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()) + 1e-12,
                                   err_msg=key)


@pytest.mark.slow
def test_recompute_and_chunked_loss_match_jax_recompute():
    for knobs in ({}, dict(recompute="full"), dict(recompute="selective"),
                  dict(loss_seq_chunks=2), dict(loss_seq_chunks=4)):
        _check_against_jax(**knobs)
