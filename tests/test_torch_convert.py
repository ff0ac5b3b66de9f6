"""``apex_tpu_torch.convert``: apex_tpu's GPT, BERT, encoder-decoder and
ResNet parameter trees (as numpy; the ResNet's stages are lists, and its
batch-norm state a second tree) onto the port's models and back, leaf for
leaf, by shape and value (exact: a conversion is a copy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models.bert import BertModel as JaxBert
from apex_tpu.models.encoder_decoder import EncoderDecoderModel as JaxEncDec
from apex_tpu.models.resnet import ResNet as JaxResNet
from apex_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from apex_tpu_torch.convert import (
    load_jax_params,
    params_from_jax,
    params_to_jax,
    state_from_jax,
    state_to_jax,
)
from apex_tpu_torch.models import (
    BertModel,
    EncoderDecoderModel,
    GPTModel,
    ResNet,
    ResNetConfig,
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
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else enumerate(tree))
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


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



def _assert_same_tree(back, tree):
    want, got = list(_leaves(tree)), list(_leaves(back))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(want, got):
        assert b.shape == a.shape, path
        np.testing.assert_array_equal(b, np.asarray(a, np.float32), path)


@pytest.mark.parametrize("depth", [18, 50])
def test_resnet_round_trip_params_and_state(depth):
    """Stages are lists of block dicts: ``layer1/0/conv1`` is the port's
    ``layer1.0.conv1`` (HWIO kept); the batch-norm state loads into the
    buffers and comes back as the JAX state tree, lists and all."""
    jm = JaxResNet(JaxResNetConfig(depth=depth, num_classes=10, width=16))
    params, state = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    rng = np.random.RandomState(0)
    state = jax.tree.map(lambda v: v + rng.rand(*v.shape).astype(v.dtype),
                         state)
    model = ResNet(ResNetConfig(depth=depth, num_classes=10, width=16),
                   device="cpu")
    load_jax_params(model, params, state)
    assert model.layer1[0].conv1.shape == params["layer1"][0]["conv1"].shape
    assert isinstance(params_to_jax(dict(model.named_parameters()))
                      ["layer1"], list)
    _assert_same_tree(params_to_jax(dict(model.named_parameters())), params)
    _assert_same_tree(state_to_jax(model), state)
    assert set(state_from_jax(state)) == {n for n, _ in model.named_buffers()}


def test_resnet_load_checks_keys():
    """Parameters must all be given; buffers only when a state is."""
    jm = JaxResNet(JaxResNetConfig(depth=18, num_classes=4, width=8))
    params, state = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    model = ResNet(ResNetConfig(depth=18, num_classes=4, width=8),
                   device="cpu")
    load_jax_params(model, params)              # buffers keep their values
    del state["layer4"][1]["bn2"]
    with pytest.raises(RuntimeError, match="layer4.1.bn2.mean"):
        load_jax_params(model, params, state)
    del params["fc"]
    with pytest.raises(RuntimeError, match="fc.kernel"):
        load_jax_params(model, params)
