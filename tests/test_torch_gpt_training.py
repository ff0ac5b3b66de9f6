"""The port's training slice against the JAX package, end to end, on the CPU.

Both packages get the same weights (``params_from_jax``) and the same
numpy-made tokens and labels. Held here, for learned positions + LayerNorm
+ GELU and for RoPE (half the head dim) + RMSNorm + SwiGLU + GQA:

- the loss and EVERY gradient leaf of ``GPTModel`` against
  ``jax.value_and_grad(model.apply)``, leaf by leaf through
  ``grads_to_jax`` (the tied word embedding sums the lookup's and the LM
  head's gradients on both sides);
- three ``make_train_step`` steps with ``FusedAdam`` against the JAX
  package's ``make_train_step`` on a one-device mesh: matching losses,
  then every parameter to atol 1e-4 (see the test for why absolute);
- the cache-free forward takes the packed attention path, and the
  training knobs that once raised (dropout, recompute, the chunked loss)
  run.

The JAX side runs its plain path, pinned per test. Tolerances (f32): the
loss rtol 1e-5; each gradient leaf atol 1e-5 of its largest magnitude (the
attention backward is the hand-written algebra on one side and JAX
autodiff of the reference on the other; the sums run in other orders).
A bf16 run is in the slow tier, to a stated tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.ops import _support as jax_support
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.training import make_train_step as jax_make_train_step
from apex_tpu_torch.convert import grads_to_jax, load_jax_params, params_to_jax
from apex_tpu_torch.models import GPTModel, TransformerConfig
from apex_tpu_torch.models import transformer as ttransformer
from apex_tpu_torch.ops import LAUNCHES
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.training import make_train_step

TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64, hidden_dropout=0.0,
            attention_dropout=0.0)
VARIANTS = {
    "learned": {},
    "rope_rms_swiglu_gqa": dict(position_embedding_type="rope",
                                rotary_percent=0.5, normalization="rmsnorm",
                                activation="swiglu", num_query_groups=2),
}
BATCH, SEQ = 2, 24


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    """Pin apex_tpu to its plain jnp path: other test modules export
    ``APEX_TPU_FORCE_PALLAS=interpret`` process-wide at import."""
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


def _pair(variant, compute=jnp.float32):
    extra = VARIANTS[variant]
    tdtype = torch.float32 if compute == jnp.float32 else torch.bfloat16
    jm = JaxGPT(JaxConfig(**TINY, **extra, compute_dtype=compute))
    params = jm.init(jax.random.PRNGKey(3))
    tm = GPTModel(TransformerConfig(**TINY, **extra, compute_dtype=tdtype),
                  device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, TINY["vocab_size"], (BATCH, SEQ))
    labels = rng.randint(0, TINY["vocab_size"], (BATCH, SEQ))
    return tokens.astype(np.int32), labels.astype(np.int32)


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _check_grads(jgrads, tgrads, rel=1e-5):
    want, got = _leaves(jgrads), _leaves(tgrads)
    assert want.keys() == got.keys()
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0,
                                   atol=rel * float(np.abs(w).max()) + 1e-12,
                                   err_msg=key)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_every_grad_leaf_match_jax(variant):
    jm, params, tm = _pair(variant)
    tokens, labels = _batch()
    mask = np.ones((BATCH, SEQ), np.float32)
    mask[1, 10:] = 0.0                  # a padded tail: masked mean
    jloss, jgrads = jax.value_and_grad(lambda p: jm.apply(
        p, jnp.asarray(tokens), jnp.asarray(labels),
        loss_mask=jnp.asarray(mask)))(params)
    before = dict(LAUNCHES)
    tloss = tm(torch.from_numpy(tokens).long(),
               torch.from_numpy(labels).long(),
               loss_mask=torch.from_numpy(mask))
    tloss.backward()
    assert LAUNCHES == before           # CPU tensors launch no kernel
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _check_grads(jgrads, grads_to_jax(tm))


def _jax_train_step(jm, opt, params):
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    spec = jax.tree.map(lambda _: PartitionSpec(), params)
    return jax_make_train_step(
        lambda p, batch, rng: jm.apply(p, batch[0], batch[1]), opt, mesh,
        spec, (PartitionSpec(), PartitionSpec()), params_template=params,
        donate=False)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_three_train_steps_match_jax(variant):
    jm, params, tm = _pair(variant)
    tokens, labels = _batch(1)
    jopt = JaxFusedAdam(lr=1e-3, weight_decay=0.01)
    jstep = _jax_train_step(jm, jopt, params)
    jstate = jopt.init(params)
    step = make_train_step(lambda batch: tm(*batch),
                           FusedAdam(tm.parameters(), lr=1e-3,
                                     weight_decay=0.01))
    batch = (torch.from_numpy(tokens).long(), torch.from_numpy(labels).long())
    jlosses, tlosses = [], []
    for _ in range(3):
        params, jstate, jloss = jstep(params, jstate,
                                      (jnp.asarray(tokens),
                                       jnp.asarray(labels)), None)
        jlosses.append(float(jloss))
        tlosses.append(float(step(batch)))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    # The parameters after three updates, leaf by leaf, to atol 1e-4: 1/30
    # of the 3·lr that three Adam steps can move a weight. The key bias's
    # gradient is zero in exact arithmetic (softmax ignores a shift of
    # every score in a row), so Adam scales each side's rounding noise in
    # it up to a step that no relative bound on the leaf can hold.
    want, got = _leaves(params), _leaves(params_to_jax(tm.state_dict()))
    assert want.keys() == got.keys()
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-4,
                                   err_msg=key)


def test_cache_free_forward_takes_the_packed_path(monkeypatch):
    """``ParallelAttention`` without a cache hands the fused projection to
    ``flash_attention_packed``, and the logits match the JAX model's."""
    jm, params, tm = _pair("rope_rms_swiglu_gqa")
    calls = []
    packed = ttransformer.flash_attention_packed

    def counting(*args, **kwargs):
        calls.append(1)
        return packed(*args, **kwargs)

    monkeypatch.setattr(ttransformer, "flash_attention_packed", counting)
    tokens, _ = _batch(2)
    with torch.no_grad():
        logits = tm(torch.from_numpy(tokens).long())
    assert len(calls) == TINY["num_layers"]
    want = jm.apply(params, jnp.asarray(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_unported_training_knobs_raise():
    """The training knobs that raised before their port (dropout, a
    truthy ``recompute``, ``loss_seq_chunks`` > 1) now run and raise
    nothing: without an ``rng`` key dropout draws nothing (as the JAX
    ``_dropout`` does with no key), and recompute and the chunked loss
    leave the loss bitwise as it was. Their JAX comparisons are in
    ``test_torch_dropout.py`` and ``test_torch_recompute.py``."""
    tokens = torch.zeros(1, 4, dtype=torch.long)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # CPU GEMMs in one order run to run
    try:
        base = GPTModel(TransformerConfig(**TINY), device="cpu",
                        generator=torch.Generator().manual_seed(0))(
            tokens, tokens)
        for knob in (dict(hidden_dropout=0.1, attention_dropout=0.1),
                     dict(recompute=True), dict(recompute="selective"),
                     dict(loss_seq_chunks=2)):
            model = GPTModel(TransformerConfig(**dict(TINY, **knob)),
                             device="cpu",
                             generator=torch.Generator().manual_seed(0))
            loss = model(tokens, tokens, deterministic=False)
            loss.backward()
            assert torch.equal(loss.detach(), base.detach()), knob
    finally:
        torch.set_num_threads(threads)


@pytest.mark.slow
def test_bf16_train_steps_match_jax_to_tolerance():
    """bf16 compute over fp32 params (the bench.py recipe at tiny widths):
    the two frameworks round bf16 at other points (JAX's reference
    attention takes bf16 probabilities into P V; the port's plain version
    keeps them fp32), so three losses agree to rtol 2e-2."""
    jm, params, tm = _pair("learned", compute=jnp.bfloat16)
    tokens, labels = _batch(3)
    jopt = JaxFusedAdam(lr=1e-3)
    jstep = _jax_train_step(jm, jopt, params)
    jstate = jopt.init(params)
    step = make_train_step(lambda batch: tm(*batch),
                           FusedAdam(tm.parameters(), lr=1e-3))
    batch = (torch.from_numpy(tokens).long(), torch.from_numpy(labels).long())
    for _ in range(3):
        params, jstate, jloss = jstep(params, jstate,
                                      (jnp.asarray(tokens),
                                       jnp.asarray(labels)), None)
        np.testing.assert_allclose(float(step(batch)), float(jloss),
                                   rtol=2e-2)
