"""The port's encoder-decoder against the JAX package, on the CPU.

Both packages get the same weights (``load_jax_params``) and the same
numpy-made encoder and decoder tokens and labels; the encoder batch is
right-padded, given either as ``enc_lengths`` (one row at full length) or
as the boolean ``enc_padding_mask``. Held here, for learned positions +
LayerNorm + GELU and for the T5-style RMSNorm + ReLU + GQA:

- the loss and EVERY gradient leaf of ``EncoderDecoderModel`` against
  ``jax.value_and_grad(model.apply)``, leaf by leaf through
  ``grads_to_jax`` (the tied embedding sums the encoder's and decoder's
  lookups and the LM head's gradients on both sides);
- three ``make_train_step`` steps with ``FusedAdam`` against the JAX
  package's ``make_train_step``: matching losses and parameters;
- with ``enc_lengths`` the encoder takes the packed flash path with
  ``kv_lengths`` and the decoder's cross-attention the 4D flash forward
  and backward (Kernels B and I on the card); with ``enc_padding_mask`` both
  take the fused masked softmax (Kernels G and H).

The JAX side runs its plain path, pinned per test. Tolerances (f32): the
loss rtol 1e-5; each gradient leaf atol 1e-5 of its largest magnitude;
parameters after three Adam steps atol 1e-4 (1/30 of the 3 lr three steps
can move a weight; a gradient that is zero in exact arithmetic, like the
key bias's, is rounding noise that Adam scales toward lr-sized steps). A
bf16 run is in the slow tier, to a stated tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models.encoder_decoder import EncoderDecoderModel as JaxEncDec
from apex_tpu.ops import _support as jax_support
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.training import make_train_step as jax_make_train_step
from apex_tpu_torch.convert import grads_to_jax, load_jax_params, params_to_jax
from apex_tpu_torch.models import EncoderDecoderModel, TransformerConfig
from apex_tpu_torch.models import transformer as ttransformer
from apex_tpu_torch.ops import LAUNCHES
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.training import make_train_step

TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64, hidden_dropout=0.0,
            attention_dropout=0.0)
VARIANTS = {
    "learned_gelu": {},
    "t5_rms_relu_gqa": dict(normalization="rmsnorm", activation="relu",
                            ffn_hidden_size=96, num_query_groups=2),
}
BATCH, S_ENC, S_DEC = 3, 24, 10
LENGTHS = np.array([24, 13, 19], np.int32)


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    """Pin apex_tpu to its plain jnp path: other test modules export
    ``APEX_TPU_FORCE_PALLAS=interpret`` process-wide at import."""
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


def _pair(variant="learned_gelu", compute=jnp.float32):
    extra = VARIANTS[variant]
    tdtype = torch.float32 if compute == jnp.float32 else torch.bfloat16
    jm = JaxEncDec(JaxConfig(**TINY, **extra, compute_dtype=compute))
    params = jm.init(jax.random.PRNGKey(7))
    tm = EncoderDecoderModel(TransformerConfig(**TINY, **extra,
                                               compute_dtype=tdtype),
                             device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    enc = rng.randint(0, TINY["vocab_size"], (BATCH, S_ENC)).astype(np.int32)
    dec = rng.randint(0, TINY["vocab_size"], (BATCH, S_DEC)).astype(np.int32)
    labels = rng.randint(0, TINY["vocab_size"],
                         (BATCH, S_DEC)).astype(np.int32)
    return enc, dec, labels


def _padding(kind):
    """``(jax kwargs, torch kwargs)`` for the encoder padding ``kind``."""
    if kind == "enc_lengths":
        return ({"enc_lengths": jnp.asarray(LENGTHS)},
                {"enc_lengths": torch.from_numpy(LENGTHS)})
    pad = np.arange(S_ENC)[None, :] >= LENGTHS[:, None]
    return ({"enc_padding_mask": jnp.asarray(pad)},
            {"enc_padding_mask": torch.from_numpy(pad)})


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("kind", ["enc_lengths", "enc_padding_mask"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_every_grad_leaf_match_jax(variant, kind):
    jm, params, tm = _pair(variant)
    enc, dec, labels = _batch()
    jkw, tkw = _padding(kind)
    loss_mask = np.ones((BATCH, S_DEC), np.float32)
    loss_mask[2, 6:] = 0.0
    jloss, jgrads = jax.value_and_grad(lambda p: jm.apply(
        p, jnp.asarray(enc), jnp.asarray(dec), jnp.asarray(labels),
        loss_mask=jnp.asarray(loss_mask), **jkw))(params)
    before = dict(LAUNCHES)
    tloss = tm(torch.from_numpy(enc).long(), torch.from_numpy(dec).long(),
               torch.from_numpy(labels).long(),
               loss_mask=torch.from_numpy(loss_mask), **tkw)
    tloss.backward()
    assert LAUNCHES == before           # CPU tensors launch no kernel
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    want, got = _leaves(jgrads), _leaves(grads_to_jax(tm))
    assert want.keys() == got.keys()
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()) + 1e-12,
                                   err_msg=key)


def test_logits_without_labels_match_jax():
    jm, params, tm = _pair("t5_rms_relu_gqa")
    enc, dec, _ = _batch(1)
    jkw, tkw = _padding("enc_lengths")
    want = jm.apply(params, jnp.asarray(enc), jnp.asarray(dec), **jkw)
    with torch.no_grad():
        got = tm(torch.from_numpy(enc).long(), torch.from_numpy(dec).long(),
                 **tkw)
    assert got.shape == (S_DEC, BATCH, TINY["vocab_size"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def _jax_train_step(jm, opt, params, jkw):
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    spec = jax.tree.map(lambda _: PartitionSpec(), params)
    return jax_make_train_step(
        lambda p, batch, rng: jm.apply(p, *batch, **jkw), opt, mesh, spec,
        (PartitionSpec(),) * 3, params_template=params, donate=False)


@pytest.mark.parametrize("kind", ["enc_lengths", "enc_padding_mask"])
def test_three_train_steps_match_jax(kind):
    jm, params, tm = _pair("t5_rms_relu_gqa")
    enc, dec, labels = _batch(2)
    jkw, tkw = _padding(kind)
    jopt = JaxFusedAdam(lr=1e-3, weight_decay=0.01)
    jstep = _jax_train_step(jm, jopt, params, jkw)
    jstate = jopt.init(params)
    step = make_train_step(lambda b: tm(*b, **tkw),
                           FusedAdam(tm.parameters(), lr=1e-3,
                                     weight_decay=0.01))
    batch = tuple(torch.from_numpy(a).long() for a in (enc, dec, labels))
    jlosses, tlosses = [], []
    for _ in range(3):
        params, jstate, jloss = jstep(params, jstate,
                                      tuple(jnp.asarray(a)
                                            for a in (enc, dec, labels)),
                                      None)
        jlosses.append(float(jloss))
        tlosses.append(float(step(batch)))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    want, got = _leaves(params), _leaves(params_to_jax(tm.state_dict()))
    assert want.keys() == got.keys()
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("kind,paths", [
    ("enc_lengths", {"packed": 4, "flash": 2, "masked": 0}),
    ("enc_padding_mask", {"packed": 2, "flash": 0, "masked": 4}),
])
def test_padding_routes(monkeypatch, kind, paths):
    """``enc_lengths``: encoder self-attention on the packed path with
    kv_lengths (Kernels E/F) and cross-attention on 4D flash (B/I); the
    decoder's causal self-attention is packed either way.
    ``enc_padding_mask``: encoder and cross-attention through the masked
    softmax (G/H)."""
    _, _, tm = _pair()
    calls = {"packed": 0, "flash": 0, "masked": 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(
        ttransformer, "flash_attention_packed",
        counting("packed", ttransformer.flash_attention_packed))
    monkeypatch.setattr(ttransformer, "flash_attention",
                        counting("flash", ttransformer.flash_attention))
    monkeypatch.setattr(
        ttransformer.FusedScaleMaskSoftmax, "forward_fused_softmax",
        counting("masked",
                 ttransformer.FusedScaleMaskSoftmax.forward_fused_softmax))
    enc, dec, labels = _batch(3)
    with torch.no_grad():
        tm(torch.from_numpy(enc).long(), torch.from_numpy(dec).long(),
           torch.from_numpy(labels).long(), **_padding(kind)[1])
    assert calls == paths


def test_both_masks_raise():
    _, _, tm = _pair()
    enc, dec, _ = _batch()
    with pytest.raises(ValueError, match="not both"):
        tm(torch.from_numpy(enc).long(), torch.from_numpy(dec).long(),
           enc_lengths=torch.from_numpy(LENGTHS),
           enc_padding_mask=torch.zeros(BATCH, S_ENC, dtype=torch.bool))
    with pytest.raises(ValueError, match="num_encoder_layers"):
        EncoderDecoderModel(TransformerConfig(**TINY), num_encoder_layers=0,
                            device="cpu")


@pytest.mark.slow
def test_bf16_train_steps_match_jax_to_tolerance():
    """bf16 compute over fp32 params with ``enc_lengths`` (the T5 recipe
    at tiny widths): the frameworks round bf16 at other points in the
    GEMMs and the reference attention, so three losses agree to rtol
    2e-2."""
    jm, params, tm = _pair("t5_rms_relu_gqa", compute=jnp.bfloat16)
    enc, dec, labels = _batch(4)
    jkw, tkw = _padding("enc_lengths")
    jopt = JaxFusedAdam(lr=1e-3)
    jstep = _jax_train_step(jm, jopt, params, jkw)
    jstate = jopt.init(params)
    step = make_train_step(lambda b: tm(*b, **tkw),
                           FusedAdam(tm.parameters(), lr=1e-3))
    batch = tuple(torch.from_numpy(a).long() for a in (enc, dec, labels))
    for _ in range(3):
        params, jstate, jloss = jstep(params, jstate,
                                      tuple(jnp.asarray(a)
                                            for a in (enc, dec, labels)),
                                      None)
        np.testing.assert_allclose(float(step(batch)), float(jloss),
                                   rtol=2e-2)
