"""``apex_tpu_torch.convert``: apex_tpu's GPT, BERT and encoder-decoder
parameter trees (as numpy) onto the port's models and back, leaf for leaf,
by shape and value (exact: a conversion is a copy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models.bert import BertModel as JaxBert
from apex_tpu.models.encoder_decoder import EncoderDecoderModel as JaxEncDec
from apex_tpu_torch.convert import (
    load_jax_params,
    params_from_jax,
    params_to_jax,
)
from apex_tpu_torch.models import (
    BertModel,
    EncoderDecoderModel,
    GPTModel,
    TransformerConfig,
)

TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64)
VARIANTS = {"learned": {},
            "rope_rms_swiglu_gqa": dict(position_embedding_type="rope",
                                        normalization="rmsnorm",
                                        activation="swiglu",
                                        num_query_groups=2)}


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("params_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_round_trip_every_leaf(variant, params_dtype):
    extra = VARIANTS[variant]
    jm = JaxGPT(JaxConfig(**TINY, **extra,
                          params_dtype=getattr(jnp, params_dtype)))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    model = GPTModel(TransformerConfig(
        **TINY, **extra, params_dtype=getattr(torch, params_dtype)),
        device="cpu")
    load_jax_params(model, tree)
    back = params_to_jax(model.state_dict())
    want, got = list(_leaves(tree)), list(_leaves(back))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(want, got):
        assert b.shape == a.shape, path
        np.testing.assert_array_equal(b, np.asarray(a, np.float32), path)


@pytest.mark.slow
def test_round_trip_at_gpt2_width():
    """The serving slice's width (GPT-2 124M: hidden 768, 12 heads, vocab
    50304, 1024 positions) at two layers, bf16 leaves."""
    cfg = dict(num_layers=2, hidden_size=768, num_attention_heads=12,
               vocab_size=50304, max_position_embeddings=1024)
    jm = JaxGPT(JaxConfig(**cfg, params_dtype=jnp.bfloat16))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(4)))
    model = GPTModel(TransformerConfig(**cfg, params_dtype=torch.bfloat16),
                     device="cpu")
    load_jax_params(model, tree)
    back = params_to_jax(model.state_dict())
    for (path, a), (_, b) in zip(_leaves(tree), _leaves(back)):
        assert b.shape == a.shape, path
        np.testing.assert_array_equal(b, np.asarray(a, np.float32), path)


def test_layers_split_and_weights_stay_out_in():
    jm = JaxGPT(JaxConfig(**TINY))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    state = params_from_jax(tree)
    qkv = tree["transformer"]["layers"]["self_attention"]["query_key_value"]
    for i in range(TINY["num_layers"]):
        key = f"transformer.layers.{i}.self_attention.query_key_value.weight"
        np.testing.assert_array_equal(state[key].numpy(), qkv["weight"][i])
    assert state["embedding.word_embeddings.weight"].shape == (128, 64)
    assert state["transformer.layers.0.mlp.dense_h_to_4h.weight"].shape == \
        (256, 64)


def test_missing_leaf_is_refused():
    jm = JaxGPT(JaxConfig(**TINY))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    del tree["transformer"]["final_layernorm"]
    with pytest.raises(RuntimeError, match="final_layernorm"):
        load_jax_params(GPTModel(TransformerConfig(**TINY), device="cpu"),
                        tree)


@pytest.mark.parametrize("jax_cls,cls", [(JaxBert, BertModel),
                                         (JaxEncDec, EncoderDecoderModel)],
                         ids=["bert", "encoder_decoder"])
def test_round_trip_bert_and_encoder_decoder(jax_cls, cls):
    """BERT's tokentype table, LM head and binary head; the encoder's and
    decoder's stacked layers (the decoder's with cross-attention and its
    norm)."""
    jm = jax_cls(JaxConfig(**TINY, normalization="rmsnorm"))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    model = cls(TransformerConfig(**TINY, normalization="rmsnorm"),
                device="cpu")
    load_jax_params(model, tree)
    back = params_to_jax(model.state_dict())
    want, got = list(_leaves(tree)), list(_leaves(back))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(b, np.asarray(a, np.float32), path)

