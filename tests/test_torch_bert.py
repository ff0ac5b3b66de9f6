"""The port's BERT against the JAX package, on the CPU.

Both packages get the same weights (``load_jax_params``) and the same
numpy-made tokens, padding masks (a row padded from position 15, so its
padded query rows mask every key), tokentype ids (0 before a split point,
1 after) and labels. Held here, with and without the padding mask:

- the LM loss, the binary logits and EVERY gradient leaf of ``BertModel``
  against ``jax.value_and_grad(model.apply)``, leaf by leaf through
  ``grads_to_jax`` (the binary head takes no part in the LM loss: its
  leaves are zero on both sides);
- three ``make_train_step`` steps with ``FusedLAMB`` against the JAX
  package's ``make_train_step``: matching losses, then every parameter
  (the binary head included: LAMB's decoupled decay moves it with a zero
  gradient, by ``1 - lr`` a step on the pooler). These runs take one
  layer: the JAX trust ratio spans each layer-stacked ``[L, ...]`` leaf,
  the port's (apex's) one parameter, and the two are the same tensor only
  where ``L = 1``;
- with a padding mask the layers take the masked path
  (``scaled_masked_softmax``, Kernels G and H on the card), without one the
  packed flash path.

The JAX side runs its plain path, pinned per test. Tolerances (f32): the
loss rtol 1e-5; each gradient leaf atol 1e-5 of its largest magnitude;
parameters after three steps atol 1e-5 (LAMB's steps are lr-sized along
the trust ratio, and both sides run the same fp32 algebra). A bf16 run is
in the slow tier, to a stated tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models.bert import BertModel as JaxBert
from apex_tpu.ops import _support as jax_support
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.training import make_train_step as jax_make_train_step
from apex_tpu_torch.convert import (
    grads_to_jax,
    load_jax_params,
    params_to_jax,
)
from apex_tpu_torch.models import BertModel, TransformerConfig
from apex_tpu_torch.models import transformer as ttransformer
from apex_tpu_torch.ops import LAUNCHES
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.training import make_train_step

TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64, hidden_dropout=0.0,
            attention_dropout=0.0)
BATCH, SEQ = 2, 24


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    """Pin apex_tpu to its plain jnp path: other test modules export
    ``APEX_TPU_FORCE_PALLAS=interpret`` process-wide at import."""
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


def _pair(compute=jnp.float32, **extra):
    tdtype = torch.float32 if compute == jnp.float32 else torch.bfloat16
    cfg = dict(TINY, **extra)
    jm = JaxBert(JaxConfig(**cfg, compute_dtype=compute))
    params = jm.init(jax.random.PRNGKey(5))
    tm = BertModel(TransformerConfig(**cfg, compute_dtype=tdtype),
                   device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _batch(seed=0, padded=True):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, TINY["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    labels = rng.randint(0, TINY["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    pad = np.ones((BATCH, SEQ), bool)
    pad[1, 15:] = False
    split = rng.randint(4, SEQ - 4, BATCH)
    types = (np.arange(SEQ)[None, :] >= split[:, None]).astype(np.int32)
    return tokens, (pad if padded else None), types, labels


def _jax_args(batch):
    return tuple(None if a is None else jnp.asarray(a) for a in batch)


def _torch_args(batch):
    tokens, pad, types, labels = batch
    return (torch.from_numpy(tokens).long(),
            None if pad is None else torch.from_numpy(pad),
            torch.from_numpy(types).long(), torch.from_numpy(labels).long())


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("padded", [True, False], ids=["padding_mask",
                                                       "no_mask"])
def test_loss_binary_logits_and_every_grad_leaf_match_jax(padded):
    jm, params, tm = _pair()
    batch = _batch(padded=padded)
    (jloss, jbin), jgrads = jax.value_and_grad(
        lambda p: jm.apply(p, *_jax_args(batch)), has_aux=True)(params)
    before = dict(LAUNCHES)
    tloss, tbin = tm(*_torch_args(batch))
    tloss.backward()
    assert LAUNCHES == before           # CPU tensors launch no kernel
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(tbin.detach().numpy(), np.asarray(jbin),
                               atol=1e-6, rtol=0)
    want, got = _leaves(jgrads), _leaves(grads_to_jax(tm))
    assert want.keys() == got.keys()
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()) + 1e-12,
                                   err_msg=key)
    assert not np.any(got["['binary_head']['pooler']['weight']"])


def test_logits_without_labels_match_jax():
    jm, params, tm = _pair()
    tokens, pad, types, _ = _batch(1)
    jlogits, jbin = jm.apply(params, jnp.asarray(tokens), jnp.asarray(pad),
                             jnp.asarray(types))
    with torch.no_grad():
        tlogits, tbin = tm(*_torch_args((tokens, pad, types, tokens))[:3])
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(tbin.numpy(), np.asarray(jbin), atol=1e-6)


def _jax_train_step(jm, opt, params):
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    spec = jax.tree.map(lambda _: PartitionSpec(), params)
    return jax_make_train_step(
        lambda p, batch, rng: jm.apply(p, *batch)[0], opt, mesh, spec,
        (PartitionSpec(),) * 4, params_template=params, donate=False)


def test_three_lamb_steps_match_jax():
    jm, params, tm = _pair(num_layers=1)
    batch = _batch(2)
    jopt = JaxFusedLAMB(lr=1e-3, weight_decay=0.01)
    jstep = _jax_train_step(jm, jopt, params)
    jstate = jopt.init(params)
    pooler0 = tm.binary_head.pooler.weight.detach().clone()
    step = make_train_step(lambda b: tm(*b)[0],
                           FusedLAMB(tm.parameters(), lr=1e-3,
                                     weight_decay=0.01))
    jlosses, tlosses = [], []
    for _ in range(3):
        params, jstate, jloss = jstep(params, jstate, _jax_args(batch), None)
        jlosses.append(float(jloss))
        tlosses.append(float(step(_torch_args(batch))))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    want, got = _leaves(params), _leaves(params_to_jax(tm.state_dict()))
    assert want.keys() == got.keys()
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-5,
                                   err_msg=key)
    # zero gradient, decoupled decay: the trust ratio ||p|| / ||wd p|| makes
    # each step p <- (1 - lr) p
    torch.testing.assert_close(tm.binary_head.pooler.weight.detach(),
                               pooler0 * (1 - 1e-3) ** 3, atol=1e-7,
                               rtol=1e-6)


@pytest.mark.parametrize("padded,masked_calls", [(True, 2), (False, 0)],
                         ids=["padding_mask", "no_mask"])
def test_padding_mask_takes_the_masked_softmax_path(monkeypatch, padded,
                                                    masked_calls):
    """With a padding mask every layer's scores go through the fused masked
    softmax (Kernel G on the card); without one, the packed flash path."""
    _, _, tm = _pair()
    calls = {"masked": 0, "packed": 0}
    softmax = ttransformer.FusedScaleMaskSoftmax.forward_fused_softmax
    packed = ttransformer.flash_attention_packed

    def counting_softmax(self, *args):
        calls["masked"] += 1
        return softmax(self, *args)

    def counting_packed(*args, **kwargs):
        calls["packed"] += 1
        return packed(*args, **kwargs)

    monkeypatch.setattr(ttransformer.FusedScaleMaskSoftmax,
                        "forward_fused_softmax", counting_softmax)
    monkeypatch.setattr(ttransformer, "flash_attention_packed",
                        counting_packed)
    with torch.no_grad():
        tm(*_torch_args(_batch(3, padded=padded)))
    assert calls == {"masked": masked_calls,
                     "packed": TINY["num_layers"] - masked_calls}


def test_build_attention_mask_masks_padded_rows_and_columns():
    pad = torch.tensor([[True, True, False]])
    mask = BertModel.build_attention_mask(pad)
    assert mask.shape == (1, 1, 3, 3) and mask.dtype == torch.bool
    assert mask[0, 0].tolist() == [[False, False, True],
                                   [False, False, True],
                                   [True, True, True]]


@pytest.mark.slow
def test_bf16_lamb_steps_match_jax_to_tolerance():
    """bf16 compute over fp32 params with a padding mask: the unfused
    attention products round at the same points (scores, probabilities)
    but the two frameworks' bf16 GEMMs and GELU round differently, so three
    losses agree to rtol 2e-2."""
    jm, params, tm = _pair(compute=jnp.bfloat16, num_layers=1)
    batch = _batch(4)
    jopt = JaxFusedLAMB(lr=1e-3)
    jstep = _jax_train_step(jm, jopt, params)
    jstate = jopt.init(params)
    step = make_train_step(lambda b: tm(*b)[0],
                           FusedLAMB(tm.parameters(), lr=1e-3))
    for _ in range(3):
        params, jstate, jloss = jstep(params, jstate, _jax_args(batch), None)
        np.testing.assert_allclose(float(step(_torch_args(batch))),
                                   float(jloss), rtol=2e-2)
