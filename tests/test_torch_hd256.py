"""Head dims past 128 (Kernels B, I, E and F up to 256) against the JAX
package, on the CPU.

The plain versions the wrappers run on a CPU tensor, and which the card
checks hold each kernel to, are einsums over any head dim; these tests
hold them, at head_dim 256 and 160, to the JAX package's Pallas kernels in
interpret mode:

- packed QKV (Kernels E and F): MQA 8:1 (one K/V group of 8 query heads)
  with RoPE over all 256 columns, a sliding window, ``kv_lengths``
  holding a 0 row and hash dropout; head_dim 160 with two groups of 2
  (the shapes JAX's 128-lane packed geometry takes);
- 4D (Kernels B and I): GQA 4:1 causal with ``kv_lengths`` and a 0 row,
  head_dim 160 over ``kv_lengths`` with sq != sk (the single-block
  kernels, whose function the multi-block ones share; an interpret-mode
  call costs ~1-2 s of tracing whatever the shape);

head_dim 256 in f32, bf16 and fp16, head_dim 160 in fp16. The tolerances are those of the d <= 128
tests (``test_torch_attention.py``, ``test_torch_fp16.py``): f32 o atol
2e-5 and gradients atol 1e-4; in bf16 and fp16 o within 1 ulp plus one
rounding step of each unnormalised p times |v| (the JAX kernels round p
to the input type before P V, the plain versions keep it fp32), and the
gradients within 1 ulp plus the rounding slack of ds and p, at most 0.1%
of the elements past 1 ulp (0.8% for Kernel I in fp16, as its d <= 128
test). The JAX backward kernels run on the same residuals as the port's
plain backward (the port's lse; packed: JAX's o, 4D: the port's o).

Then a tiny GPT at head_dim 256 (2 layers, hidden 512, 2 query heads
over one K/V group, geglu, RMSNorm, RoPE, vocab 128, s 64): its f32 loss
and every gradient leaf against the JAX ``GPTModel``, and three
``FusedAdam`` steps' losses; in bf16 (slow) three steps to rtol 2e-2, as
``test_torch_gpt_training.py`` holds GPT-2's recipe.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.ops import _support as jax_support
from apex_tpu.ops import attention as jatt
from apex_tpu.ops import flash_attention as jax_flash
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch.convert import grads_to_jax, params_to_jax
from apex_tpu_torch.models import GPTModel, TransformerConfig
from apex_tpu_torch.ops import LAUNCHES, flash_attention
from apex_tpu_torch.ops.attention import (
    _packed_bwd_factors,
    _qk,
    flash_attention_packed,
    flash_bwd_factors,
    flash_bwd_plain,
    flash_bwd_rounding_slack,
    flash_fwd_plain,
    flash_packed_bwd_plain,
    flash_packed_bwd_rounding_slack,
    flash_packed_fwd_plain,
    rounding_step,
)
from apex_tpu_torch.ops.rope import rope_freqs, rope_tables
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.training import make_train_step

DTYPES = ["float32", "bfloat16", "float16"]


def _cases(table):
    """(case, dtype) pairs: head_dim 256 in every dtype, 160 in fp16 (the
    type with the finest rounding). An interpret-mode JAX kernel costs
    ~1-2 s to trace and compile whatever its shape, so each pair is a few
    seconds."""
    return [(n, dt) for n, case in table.items()
            for dt in (DTYPES if 256 in case[:6] else ["float16"])]

PACKED = {
    # name: (s, b, groups, qpg, d, kwargs)
    "mqa_rope256_window_kv_lengths_0_dropout": (
        64, 2, 1, 8, 256, dict(causal=True, rot=256, sliding_window=24,
                               kv_lengths=[40, 0], dropout_rate=0.2,
                               dropout_seed=-7)),
    "d160_g2_qpg2": (64, 2, 2, 2, 160, dict(causal=True, rot=160)),
}

FLASH = {
    # name: (b, h, kvh, sq, sk, d, causal, kv_lengths, window)
    "gqa4_causal_kv_lengths_0": (2, 4, 1, 96, 96, 256, True, [70, 0], None),
    "d160_kv_lengths_sq_lt_sk": (2, 4, 2, 40, 72, 160, False, [72, 19],
                                 None),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: these CPU ops are small, and beside busy test
    workers a thread per core makes them crawl."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_mode(monkeypatch):
    def set_mode(mode):
        monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", mode)
        jax_support.pallas_mode.cache_clear()
    yield set_mode
    jax_support.pallas_mode.cache_clear()


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _check_half(name, want, got, dtype, slack=0.0, max_past_ulp=1.0):
    """Every element within 1 ulp of ``dtype`` (2^-7 or 2^-10 of the
    magnitude, floored at magnitude 2^-8) plus ``slack``, at most a share
    ``max_past_ulp`` past 1 ulp."""
    eps = float(torch.finfo(dtype).eps)
    one = 2.0 ** -8 * eps + eps * np.abs(want)
    e = np.abs(got - want)
    assert np.isfinite(got).all() and np.isfinite(want).all(), name
    assert (e - one - slack).max() <= 0, \
        f"{name}: {(e - one - slack).max()} past the bound"
    assert (e > one).mean() <= max_past_ulp, \
        f"{name}: {(e > one).mean()} of the elements past 1 ulp"


# ---------------------------------------------------------------------------
# Kernels E and F: packed QKV
# ---------------------------------------------------------------------------

def _packed_inputs(case, seed, dtype):
    """qkv and do in ``dtype``, the port's arguments ``(kv_lengths, rope,
    seed, rate, scale, causal, window, qpg, d)`` and the JAX keywords."""
    s, b, g, qpg, d, kw = case
    rng = np.random.RandomState(seed)
    qkv, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .to(dtype) for shape in ((s, b, g * (qpg + 2) * d),
                                        (s, b, g * qpg * d)))
    kvl, rot = kw.get("kv_lengths"), kw.get("rot", 0)
    rate = kw.get("dropout_rate", 0.0)
    rope = None if not rot else rope_tables(rope_freqs(0, s, rot, 10000.0),
                                            s, d)
    args = (None if kvl is None else torch.tensor(kvl), rope,
            kw.get("dropout_seed"), rate, 1.0 / np.sqrt(d),
            kw.get("causal", False), kw.get("sliding_window"), qpg, d)
    jkw = dict(causal=args[5], sliding_window=args[6], dropout_rate=rate,
               kv_lengths=None if kvl is None else jnp.asarray(kvl,
                                                               jnp.int32),
               dropout_seed=None if not rate else jnp.asarray(
                   [kw["dropout_seed"]], jnp.int32))
    if rot:
        jkw["rope_freqs"] = jnp.asarray(
            rope_freqs(0, s, rot, 10000.0).reshape(s, rot).numpy())
    return qkv, do, args, jkw


def _check(name, want, got, dtype, slack, max_past_ulp=1.0):
    """f32: o atol 2e-5, gradients atol 1e-4; 16-bit: 1 ulp plus
    ``slack`` (:func:`_check_half`)."""
    assert got.dtype == dtype, name
    want, got = _f32(want), _f32(got)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=2e-5 if name == "o"
                                   else 1e-4, rtol=0, err_msg=name)
    else:
        _check_half(name, want, got, dtype, _f32(slack), max_past_ulp)


@pytest.mark.parametrize("name,dtype", _cases(PACKED))
def test_packed_plain_matches_jax_interpret_kernels(jax_mode, name, dtype):
    """E's plain version (through ``flash_attention_packed`` on CPU
    tensors) against ``_fwd_packed_kernel``, F's against
    ``_dqkv_packed_kernel`` on the same residuals (JAX's o, the port's
    lse), both in interpret mode (the JAX gate takes these shapes); a
    kv_length-0 row is zero in o and dqkv."""
    jax_mode("interpret")
    s, b, g, qpg, d, kw = PACKED[name]
    assert jatt.packed_attention_supported(s, g, qpg, d)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    qkv, do, args, jkw = _packed_inputs(PACKED[name], 4, tdt)
    jqkv = jnp.asarray(_f32(qkv), jdt)
    jo = jatt.flash_attention_packed(jqkv, queries_per_group=qpg,
                                     head_dim=d, **jkw)
    before = dict(LAUNCHES)
    o = flash_attention_packed(
        qkv, queries_per_group=qpg, head_dim=d, causal=args[5],
        sliding_window=args[6], kv_lengths=args[0],
        rope_freqs=None if args[1] is None else rope_freqs(
            0, s, kw["rot"], 10000.0).reshape(s, kw["rot"]),
        dropout_rate=args[3], dropout_seed=args[2])
    assert LAUNCHES == before           # CPU tensors launch no kernel
    _, lse = flash_packed_fwd_plain(qkv, *args)
    _, _, _, pd, _ = _packed_bwd_factors(qkv, do, o, lse, *args)
    _, _, v = _qk(qkv, qpg, d, args[1])
    h = g * qpg
    slack = torch.einsum("bhqk,bhkd->bhqd", rounding_step(pd, tdt),
                         v.float().abs())
    _check("o", jo, o, tdt, slack.permute(2, 0, 1, 3).reshape(s, b, h * d))
    cos = sin = None
    if args[1] is not None:
        cos, sin = (jnp.asarray(t.numpy()) for t in args[1][:2])
    res = (jqkv, jkw["kv_lengths"], cos, sin, jkw["dropout_seed"], jo,
           jnp.asarray(lse.numpy()).reshape(b, h, 1, s))
    want = jatt._flash_packed_vjp_bwd(
        args[4], args[5], args[6], qpg, d, kw.get("rot", 0), args[3], res,
        jnp.asarray(_f32(do), jdt))[0]
    jo_t = torch.from_numpy(_f32(jo).copy()).to(tdt)
    dqkv = flash_packed_bwd_plain(qkv, do, jo_t, lse, *args)
    _check("dqkv", want, dqkv, tdt,
           flash_packed_bwd_rounding_slack(qkv, do, jo_t, lse, *args),
           max_past_ulp=1e-3)
    kvl = kw.get("kv_lengths")
    if kvl is not None and 0 in kvl:
        r = kvl.index(0)
        assert not o[:, r].any() and not dqkv[:, r].any()


# ---------------------------------------------------------------------------
# Kernels B and I: [b, h, s, d]
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,dtype", _cases(FLASH))
def test_flash_plain_matches_jax_interpret_kernels(jax_mode, name, dtype):
    """B's plain version (through ``flash_attention`` on CPU tensors)
    against ``_fwd_single_kernel``, I's against ``_dqkv_single_kernel`` on
    the port's o and lse, both in interpret mode; a kv_length-0 row gets
    o = 0 and zero gradients."""
    jax_mode("interpret")
    b, h, kvh, sq, sk, d, causal, kvl, window = FLASH[name]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rng = np.random.RandomState(6)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   .to(tdt) for shape in ((b, h, sq, d), (b, kvh, sk, d),
                                          (b, kvh, sk, d), (b, h, sq, d)))
    tkvl = None if kvl is None else torch.tensor(kvl, dtype=torch.int32)
    jkvl = None if kvl is None else jnp.asarray(kvl, jnp.int32)
    scale = 1.0 / np.sqrt(d)
    args = (tkvl, scale, causal, window)
    jx = lambda t: jnp.asarray(_f32(t), jdt)  # noqa: E731
    want_o = jax_flash(jx(q), jx(k), jx(v), causal=causal,
                       sliding_window=window, kv_lengths=jkvl)
    before = dict(LAUNCHES)
    o = flash_attention(q, k, v, causal=causal, sliding_window=window,
                        kv_lengths=tkvl)
    assert LAUNCHES == before           # CPU tensors launch no kernel
    _, lse = flash_fwd_plain(q, k, v, *args)
    p, _ = flash_bwd_factors(q, k, v, o, o, lse, *args)
    _check("o", want_o, o, tdt, torch.einsum(
        "bhqk,bhkd->bhqd", rounding_step(p, tdt),
        v.float().abs().repeat_interleave(h // kvh, dim=1)))
    block_q, block_k = jatt._auto_blocks(None, None, sk)
    res = (jx(q), jx(k), jx(v), jkvl, jx(o), jnp.asarray(lse.numpy()))
    want = jatt._flash_vjp_bwd(scale, causal,
                               min(block_q, jatt.round_up(sq, 8)),
                               min(block_k, jatt.round_up(sk, 128)), window,
                               res, jx(do))[:3]
    grads = flash_bwd_plain(q, k, v, do, o, lse, *args)
    slack = flash_bwd_rounding_slack(q, k, v, do, o, lse, *args)
    for n, w, g_, sl in zip(("dq", "dk", "dv"), want, grads, slack):
        _check(n, w, g_, tdt, sl,
               max_past_ulp=8e-3 if tdt == torch.float16 else 1e-3)
    if kvl is not None and 0 in kvl:
        r = kvl.index(0)
        assert not o[r].any() and not any(g_[r].any() for g_ in grads)


# ---------------------------------------------------------------------------
# A tiny GPT at head_dim 256 against the JAX GPTModel
# ---------------------------------------------------------------------------

TINY_HD256 = dict(num_layers=2, hidden_size=512, num_attention_heads=2,
                  num_query_groups=1, activation="geglu",
                  normalization="rmsnorm", position_embedding_type="rope",
                  vocab_size=128, max_position_embeddings=64,
                  hidden_dropout=0.0, attention_dropout=0.0)
BATCH, SEQ = 2, 64


@pytest.fixture
def jax_plain_path(jax_mode):
    """apex_tpu on its plain jnp path (other modules export interpret
    mode process-wide at import)."""
    jax_mode("off")


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(compute: str):
    """The JAX GPTModel's jitted loss-and-grad, compiled once for the
    tests of this module."""
    jm = JaxGPT(JaxConfig(**TINY_HD256, compute_dtype=getattr(jnp, compute)))
    return jax.jit(jax.value_and_grad(lambda p, tok, lab: jm.apply(p, tok,
                                                                 lab)))


def _pair(compute="float32"):
    """The port's GPT with weights from a seed, the same weights as a JAX
    params tree (``params_to_jax``: no JAX init to compile) and JAX's
    loss-and-grad."""
    tm = GPTModel(TransformerConfig(**TINY_HD256,
                                    compute_dtype=getattr(torch, compute)),
                  device="cpu", generator=torch.Generator().manual_seed(5))
    assert tm.config.head_dim == 256
    params = jax.tree.map(jnp.asarray, params_to_jax(tm.state_dict()))
    return params, _jax_loss_and_grad(compute), tm


def _batch(seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randint(0, TINY_HD256["vocab_size"], (BATCH, SEQ))
                 .astype(np.int32) for _ in range(2))


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _three_steps(compute, rtol, grads_after_first=None):
    """Three FusedAdam steps (lr 1e-3) on both sides: JAX's as its
    ``make_train_step`` runs them on a one-device mesh (``value_and_grad``,
    then ``FusedAdam.step``), the port's through ``make_train_step``;
    ``grads_after_first(jax_grads, port_model)`` sees the first step's
    gradients (both at the initial weights)."""
    params, vg, tm = _pair(compute)
    batch_np = _batch(1)
    tokens, labels = (jnp.asarray(t) for t in batch_np)
    jopt = JaxFusedAdam(lr=1e-3)
    jstate = jopt.init(params)
    jstep = jax.jit(jopt.step)
    step = make_train_step(lambda batch: tm(*batch),
                           FusedAdam(tm.parameters(), lr=1e-3))
    batch = tuple(torch.from_numpy(t).long() for t in batch_np)
    jlosses, tlosses = [], []
    for i in range(3):
        jloss, grads = vg(params, tokens, labels)
        params, jstate = jstep(grads, params, jstate)
        jlosses.append(float(jloss))
        tlosses.append(float(step(batch)))
        if i == 0 and grads_after_first is not None:
            grads_after_first(grads, tm)
    np.testing.assert_allclose(tlosses, jlosses, rtol=rtol)
    assert tlosses[-1] < tlosses[0]


def test_hd256_gpt_loss_grads_and_adam_steps_match_jax(jax_plain_path,
                                                       monkeypatch):
    """The tiny d-256 GPT in f32: the first loss to rtol 1e-5 and every
    gradient leaf to atol 1e-5 of its largest magnitude
    (test_torch_gpt_training.py's bar), then three FusedAdam steps' losses
    to rtol 1e-5; the layers' attention takes the packed path (Kernels E
    and F on the card)."""
    from apex_tpu_torch.models import transformer as ttransformer
    calls = []
    packed = ttransformer.flash_attention_packed
    monkeypatch.setattr(ttransformer, "flash_attention_packed",
                        lambda *a, **k: calls.append(1) or packed(*a, **k))

    def check_grads(jgrads, tm):
        assert len(calls) == TINY_HD256["num_layers"]
        want, got = _leaves(jgrads), _leaves(grads_to_jax(tm))
        assert want.keys() == got.keys()
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=0,
                                       atol=1e-5 * float(np.abs(w).max())
                                       + 1e-12, err_msg=key)

    _three_steps("float32", 1e-5, check_grads)


@pytest.mark.slow
def test_hd256_gpt_bf16_steps_match_jax_to_tolerance(jax_plain_path):
    """bf16 compute over fp32 params: the frameworks round bf16 at other
    points (JAX's reference attention takes bf16 p into P V, the port's
    plain version keeps it fp32), so three losses agree to rtol 2e-2."""
    _three_steps("bfloat16", 2e-2)
