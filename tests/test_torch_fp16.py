"""fp16 (``torch.float16``) in the port's Kernels A, D, E and F, against
the JAX package on the CPU, and the dtype gates of every other kernel.

- The gates: ``dtype_code`` takes fp16 with the code of ``kF16`` in
  ``csrc/common.cuh``; the wrappers of Kernels B, C, G-M refuse fp16 with
  a TypeError before any launch, and those of A, D, E and F let it through
  to their launch (a stub build stops them there).
- Kernels A and D: the plain versions in fp16 (x in fp16; w and b in
  fp16, in fp32 or absent; y in fp16 or promoted to fp32) against the JAX
  ``_norm`` forward and its vjp with the Pallas kernels in interpret mode,
  LayerNorm and RMSNorm; dw and db are cast once to w's dtype on both
  sides, and with dy scaled far past fp16's range they overflow to inf at
  the same elements.
- Kernel E: the plain forward in fp16 against ``flash_attention_packed``
  in interpret mode over the ``PACKED`` cases of
  ``test_torch_attention.py``. The JAX kernel rounds the unnormalised
  (dropped) p to fp16 before P V, the plain version keeps p in fp32, so o
  is held to 1 fp16 ulp plus one fp16 rounding step of every p carried
  through V.
- Kernel F: the plain backward in fp16 against ``_flash_packed_vjp_bwd``
  in interpret mode on the same residuals, within 1 fp16 ulp plus
  ``flash_packed_bwd_rounding_slack`` (its step follows the dtype: 2^-11
  of |ds|, at least fp16's subnormal spacing 2^-24) with at most 0.1% of
  the elements past 1 ulp; and a cotangent scaled so that ds overflows
  fp16, where the non-finite masks of dqkv agree.
- The fp16 rounding plans of the two kernels, emulated on the CPU as
  ``test_torch_attention.py`` does for bf16: E's p scaled by 2^(14 - e)
  and split into fp16 hi + lo holds o within 1 fp16 ulp of the plain
  version at s 1024, one fp16 p does not (which decided E's fp16 plan);
  F's ds and dropped p rounded to fp16 once per 64-wide tile hold dqkv
  within 1 ulp plus the slack.

"1 fp16 ulp" is ``2^-18 + 2^-10 |want|``: one rounding step of 2^-10 of
the magnitude with the same 2^-8 magnitude floor as the bf16 checks
(``2^-15 + 2^-7 |want|``), where an fp32 summation difference among terms
of order one exceeds the ulp of a result that cancels to near zero.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from apex_tpu.ops import _support as jax_support
from apex_tpu.ops import attention as jatt
from apex_tpu.ops import layer_norm as jln
from apex_tpu_torch.ops import _build, _support
from apex_tpu_torch.ops import attention as tatt
from apex_tpu_torch.ops import layer_norm as tln
from apex_tpu_torch.ops.attention import (
    _packed_bwd_factors,
    _qk,
    _visible,
    drop_combo,
    flash_bwd_cuda,
    flash_fwd_cuda,
    flash_packed_bwd_cuda,
    flash_packed_bwd_plain,
    flash_packed_bwd_rounding_slack,
    flash_packed_fwd_cuda,
    flash_packed_fwd_plain,
    hash_keep,
    rounding_step,
)
from apex_tpu_torch.ops.conv_fused import (
    conv1x1_bwd_cuda,
    conv1x1_fwd_cuda,
    conv3x3_bwd_cuda,
    conv3x3_fwd_cuda,
)
from apex_tpu_torch.ops.decode_attention import paged_decode_cuda
from apex_tpu_torch.ops.layer_norm import (
    fused_layer_norm,
    fused_layer_norm_affine,
    fused_rms_norm,
    fused_rms_norm_affine,
    layer_norm_bwd_cuda,
    layer_norm_fwd,
    layer_norm_fwd_cuda,
)
from apex_tpu_torch.ops.rope import rope_freqs, rope_tables
from apex_tpu_torch.ops.softmax import softmax_bwd_cuda, softmax_fwd_cuda

F16 = torch.float16
COMMON_CUH = Path(_build.SOURCE_DIR) / "common.cuh"


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


def _one_ulp(want):
    """1 fp16 ulp of ``want`` (fp32 numpy), magnitude floored at 2^-8."""
    return 2.0 ** -18 + 2.0 ** -10 * np.abs(want)


def _check_fp16(name, want, got, slack=0.0, max_past_ulp=1.0):
    """Every element within 1 fp16 ulp plus ``slack``, and at most a share
    ``max_past_ulp`` of them past 1 ulp; both finite where either is."""
    assert np.array_equal(np.isfinite(want), np.isfinite(got)), name
    fin = np.isfinite(want)
    e = np.abs(got[fin] - want[fin])
    one = _one_ulp(want[fin])
    sl = slack[fin] if isinstance(slack, np.ndarray) else slack
    assert (e - one - sl).max(initial=0.0) <= 0, \
        f"{name}: {(e - one - sl).max()} past the bound"
    assert (e > one).mean() <= max_past_ulp, \
        f"{name}: {(e > one).mean()} of the elements past 1 ulp"


# ---------------------------------------------------------------------------
# dtype gates
# ---------------------------------------------------------------------------

def test_dtype_codes_match_common_cuh():
    enum = re.search(r"enum DType : int \{([^}]*)\}", COMMON_CUH.read_text())
    codes = {k.strip(): int(v) for k, v in
             (item.split("=") for item in enum.group(1).split(","))}
    allowed = _support.F32_BF16_F16
    assert _support.dtype_code(torch.float16, allowed, "X") == codes["kF16"]
    assert _support.dtype_code(torch.bfloat16, allowed, "X") == codes["kBF16"]
    assert _support.dtype_code(torch.float32, allowed, "X") == codes["kF32"]
    with pytest.raises(TypeError, match="not yet ported"):
        _support.dtype_code(torch.float16, _support.F32_BF16, "Kernel X")
    with pytest.raises(TypeError, match="Kernel X takes"):
        _support.dtype_code(torch.float64, allowed, "Kernel X")


def _t(*shape, dtype=F16):
    return torch.ones(shape, dtype=dtype)


def _f(*shape):
    return torch.ones(shape, dtype=torch.float32)


#: a call of each kernel wrapper on small CPU tensors of ``dtype``
GATED = {
    "B": lambda dt: flash_fwd_cuda(_t(1, 2, 8, 64, dtype=dt),
                                   _t(1, 2, 8, 64, dtype=dt),
                                   _t(1, 2, 8, 64, dtype=dt), None, 0.125,
                                   True),
    "I": lambda dt: flash_bwd_cuda(*(_t(1, 2, 8, 64, dtype=dt),) * 5,
                                   _f(1, 2, 8), None,
                                   0.125, True),
    "C": lambda dt: paged_decode_cuda(
        _t(2, 4, 64, dtype=dt), _t(4, 16, 128, dtype=dt),
        _t(4, 16, 128, dtype=dt), torch.zeros(2, 2, dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32), 2, None),
    "G": lambda dt: softmax_fwd_cuda(_t(1, 1, 4, 8, dtype=dt), None, 1.0, 4,
                                     False),
    "H": lambda dt: softmax_bwd_cuda(_t(4, 8, dtype=dt), _t(4, 8, dtype=dt),
                                     1.0),
    "J": lambda dt: conv1x1_fwd_cuda(_t(8, 16, dtype=dt), None, None,
                                     _t(16, 8, dtype=dt), _f(8), False,
                                     False),
    "K": lambda dt: conv1x1_bwd_cuda(
        _t(8, 16, dtype=dt), None, None, _t(16, 8, dtype=dt), _f(8),
        _t(8, 8, dtype=dt), _t(8, 8, dtype=dt), _f(2, 8), False, False),
    "L": lambda dt: conv3x3_fwd_cuda(_t(1, 4, 4, 16, dtype=dt), None, None,
                                     _t(3, 3, 16, 8, dtype=dt), _f(8),
                                     False, False),
    "M": lambda dt: conv3x3_bwd_cuda(
        _t(1, 4, 4, 16, dtype=dt), None, None, _t(3, 3, 16, 8, dtype=dt),
        _f(8), _t(1, 4, 4, 8, dtype=dt), _t(1, 4, 4, 8, dtype=dt), _f(2, 8),
        False, False),
    "A": lambda dt: layer_norm_fwd_cuda(_t(4, 64, dtype=dt),
                                        _t(64, dtype=dt), None, 1e-5, False,
                                        dt),
    "D": lambda dt: layer_norm_bwd_cuda(
        _t(4, 64, dtype=dt), _t(4, 64, dtype=dt), _f(4), _f(4),
        _t(64, dtype=dt), False, False),
    "E": lambda dt: flash_packed_fwd_cuda(_t(8, 1, 192, dtype=dt), None,
                                          None, None, 0.0, 0.125, True,
                                          None, 1, 64),
    "F": lambda dt: flash_packed_bwd_cuda(
        _t(8, 1, 192, dtype=dt), _t(8, 1, 64, dtype=dt),
        _t(8, 1, 64, dtype=dt), _f(1, 1, 8), None, None, None, 0.0, 0.125,
        True, None, 1, 64),
}


class _Launched(Exception):
    """Raised by the stub build: the wrapper passed its dtype gate."""


@pytest.fixture
def stub_build(monkeypatch):
    def library():
        raise _Launched
    monkeypatch.setattr(_build, "library", library)


@pytest.mark.parametrize("kernel", ["B", "I", "C", "G", "H", "J", "K", "L",
                                    "M"])
def test_kernels_without_fp16_refuse_it(stub_build, kernel):
    with pytest.raises(TypeError, match="float16 is not yet ported"):
        GATED[kernel](F16)
    with pytest.raises(_Launched):       # bf16 still reaches the launch
        GATED[kernel](torch.bfloat16)


@pytest.mark.parametrize("kernel", ["A", "D", "E", "F"])
def test_kernels_with_fp16_take_it(stub_build, kernel):
    with pytest.raises(_Launched):
        GATED[kernel](F16)


@pytest.mark.parametrize("x,others", [
    (F16, dict(w=torch.bfloat16)), (F16, dict(y=torch.bfloat16)),
    (torch.bfloat16, dict(w=F16)), (torch.float32, dict(dy=F16)),
    (F16, dict(dy=torch.bfloat16))])
def test_layer_norm_kernels_refuse_mixed_16_bit_types(x, others):
    with pytest.raises(TypeError):
        tln._kernel_dtypes("Kernel A", x, **others)


def test_layer_norm_kernel_dtypes():
    assert tln._kernel_dtypes("A", F16, w=F16, y=F16) == (2, 2, 2)
    assert tln._kernel_dtypes("A", F16, w=torch.float32, y=torch.float32) \
        == (2, 0, 0)
    assert tln._kernel_dtypes("D", F16, dy=torch.float32, w=None) == \
        (2, 0, 0)
    assert tln._kernel_dtypes("A", torch.bfloat16, w=torch.float32,
                              y=torch.bfloat16) == (1, 0, 1)


@pytest.mark.parametrize("x_dtype", [F16, torch.bfloat16])
def test_layer_norm_plans_send_16_bit_rows_to_the_vector_path(x_dtype):
    ptrs = (0, 16, 32, None)
    plan = tln.layer_norm_fwd_plan(8192, 768, x_dtype, ptrs, lambda _: 2,
                                   132)
    assert plan.path == "vector" and plan.pieces == 3
    bwd = tln.layer_norm_bwd_plan(8192, 768, x_dtype, x_dtype, ptrs,
                                  lambda _: 2, 132)
    assert bwd.path == "vector"
    assert tln.layer_norm_bwd_plan(8192, 768, torch.float32, x_dtype, ptrs,
                                   lambda _: 2, 132).path == "element"


def test_rounding_step_follows_the_dtype():
    t = torch.tensor([1.0, 2.0 ** -20, 0.0, -3.0])
    assert torch.equal(rounding_step(t, torch.bfloat16)[:1],
                       torch.tensor([2.0 ** -8]))
    f16 = rounding_step(t, F16)
    assert torch.equal(f16, torch.tensor([2.0 ** -11, 2.0 ** -24, 2.0 ** -24,
                                          3 * 2.0 ** -11]))


# ---------------------------------------------------------------------------
# Kernels A and D: plain versions in fp16 against the JAX interpret kernels
# ---------------------------------------------------------------------------

ROWS = 300
#: (is_rms, weight dtype or None, bias, out dtype or None)
LN_CASES = {
    "ln_w16_b16": (False, "float16", True, None),
    "ln_w32_b32": (False, "float32", True, None),
    "ln_w32_out16": (False, "float32", True, "float16"),
    "ln_no_w": (False, None, False, None),
    "rms_w16": (True, "float16", False, None),
    "rms_w32": (True, "float32", False, None),
    "rms_no_w": (True, None, False, None),
}


def _ln_fns(is_rms, affine, out):
    """The JAX and port functions of (x, w, b) for one case; ``out`` the
    output dtype's name or None (promote semantics)."""
    jkw = dict(out_dtype=None if out is None else getattr(jnp, out))
    tkw = dict(out_dtype=None if out is None else getattr(torch, out))
    if is_rms and affine:
        return (lambda x, w: jln.fused_rms_norm_affine(x, w, 96, **jkw),
                lambda x, w: fused_rms_norm_affine(x, w, 96, **tkw))
    if affine:
        return (lambda x, w, b: jln.fused_layer_norm_affine(x, w, b, 96,
                                                            **jkw),
                lambda x, w, b: fused_layer_norm_affine(x, w, b, 96, **tkw))
    jn = jln.fused_rms_norm if is_rms else jln.fused_layer_norm
    tn = fused_rms_norm if is_rms else fused_layer_norm
    return (lambda x: jn(x, 96, **jkw), lambda x: tn(x, 96, **tkw))


def _ln_run(case, seed, dy_scale=1.0):
    """(jax y, dx, dw, db) and the port's, fp32 numpy (None where absent),
    through jax.vjp and torch autograd with one numpy-made cotangent."""
    is_rms, wdt, bias, odt = LN_CASES[case]
    rng = np.random.RandomState(seed)
    x = (rng.randn(ROWS, 96) * 2.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(96)).astype(np.float32)
    b = (0.1 * rng.randn(96)).astype(np.float32)
    dy = (rng.randn(ROWS, 96) * dy_scale).astype(np.float32)
    jfn, tfn = _ln_fns(is_rms, wdt is not None, odt)
    args = [(x, "float16")]
    if wdt is not None:
        args.append((w, wdt))
        if bias:
            args.append((b, wdt))
    jargs = [jnp.asarray(a, getattr(jnp, dt)) for a, dt in args]
    jy, vjp = jax.vjp(jfn, *jargs)
    jg = vjp(jnp.asarray(dy, jy.dtype))
    targs = [torch.from_numpy(a).to(getattr(torch, dt)).requires_grad_()
             for a, dt in args]
    ty = tfn(*targs)
    assert str(ty.dtype).replace("torch.", "") == str(jy.dtype)
    ty.backward(torch.from_numpy(dy).to(ty.dtype))
    for t, (_, dt) in zip(targs, args):
        assert t.grad.dtype == getattr(torch, dt)
    pad = [None] * (3 - len(args))
    return ([_f32(jy)] + [_f32(g) for g in jg] + pad,
            [_f32(ty)] + [_f32(t.grad) for t in targs] + pad)


@pytest.mark.parametrize("case", list(LN_CASES))
def test_layer_norm_fp16_matches_jax_interpret_kernels(jax_mode, case):
    """y and dx within 1 fp16 ulp (each side computes in fp32 and rounds
    once); dw and db, fp32 sums over 300 rows in another order cast once to
    w's dtype, within 1 ulp of that dtype (fp32: atol 1e-4 + rtol 1e-5)."""
    jax_mode("interpret")
    want, got = _ln_run(case, seed=7)
    _, wdt, _, odt = LN_CASES[case]
    for name, w, g in zip(("y", "dx"), want[:2], got[:2]):
        if name == "y" and odt is None and wdt == "float32":
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        else:
            _check_fp16(name, w, g)
    for name, w, g in zip(("dw", "db"), want[2:], got[2:]):
        assert (w is None) == (g is None), name
        if w is None:
            continue
        if wdt == "float16":
            _check_fp16(name, w, g)
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("case", ["ln_w16_b16", "rms_w16"])
def test_layer_norm_fp16_weight_grads_overflow_like_jax(jax_mode, case):
    """dy scaled by 2^14, as a loss scale would: dw and db, summed over
    300 rows in fp32, pass 65504 and turn to inf at their cast to the fp16
    weight's dtype, on both sides at the same elements (the sums sit far
    past the boundary); dx stays finite and within 1 ulp."""
    jax_mode("interpret")
    scale = 2.0 ** 14
    want, got = _ln_run(case, seed=8, dy_scale=scale)
    # dx held at the unscaled magnitudes (a power of two: exact), where the
    # ulp's 2^-8 magnitude floor means what it does above
    _check_fp16("dx", want[1] / scale, got[1] / scale)
    for w, g in zip(want[2:], got[2:]):
        if w is None:
            continue
        assert not np.isfinite(w).all()
        assert np.array_equal(np.isfinite(w), np.isfinite(g))


def test_layer_norm_fp16_keeps_the_promote_semantics():
    x = torch.randn(4, 96).half()
    y, mean, iv = layer_norm_fwd(x, torch.ones(96), None, 96, 1e-5, False)
    assert y.dtype == torch.float32 and mean.dtype == torch.float32
    y, _, _ = layer_norm_fwd(x, torch.ones(96).half(), None, 96, 1e-5, False)
    assert y.dtype == F16


# ---------------------------------------------------------------------------
# Kernels E and F: plain versions in fp16 against the JAX interpret kernels
# ---------------------------------------------------------------------------

PACKED = {
    # name: (s, b, groups, qpg, d, kwargs), as test_torch_attention.py
    "causal": (64, 2, 2, 1, 64, dict(causal=True)),
    "gqa_qpg2": (64, 2, 2, 2, 64, dict(causal=True)),
    "rope_half": (64, 1, 2, 1, 64, dict(causal=True, rot=32)),
    "window": (96, 1, 2, 1, 64, dict(causal=True, sliding_window=20)),
    "kv_lengths_with_zero": (48, 3, 2, 1, 64,
                             dict(kv_lengths=[48, 20, 0])),
    "dropout": (64, 2, 2, 1, 64, dict(causal=True, dropout_rate=0.2,
                                      dropout_seed=-7)),
}


def _packed_inputs(case, seed, do_scale=1.0, v_scale=1.0):
    """fp16 qkv (its v columns times ``v_scale``) and do (times
    ``do_scale``) for one ``PACKED`` case, and the port's arguments
    ``(kv_lengths, rope, seed, rate, scale, causal, window, qpg, d)``."""
    s, b, g, qpg, d, kw = case
    rng = np.random.RandomState(seed)
    qkv = rng.randn(s, b, g, qpg + 2, d).astype(np.float32)
    qkv[:, :, :, qpg + 1] *= v_scale
    qkv = torch.from_numpy(qkv.reshape(s, b, -1)).half()
    do = torch.from_numpy((rng.randn(s, b, g * qpg * d) * do_scale).astype(
        np.float32)).half()
    kvl = kw.get("kv_lengths")
    rope = (None if "rot" not in kw
            else rope_tables(rope_freqs(0, s, kw["rot"], 10000.0), s, d))
    return qkv, do, (None if kvl is None else torch.tensor(kvl), rope,
                     kw.get("dropout_seed"), kw.get("dropout_rate", 0.0),
                     1.0 / np.sqrt(d), kw.get("causal", False),
                     kw.get("sliding_window"), qpg, d)


def _jax_packed(qkv, args):
    """JAX's packed forward in interpret mode on the same fp16 qkv:
    ``(o, residual-building kwargs, rot, cos, sin, jqkv, jkvl, jseed)``."""
    kvl, rope, dseed, rate, scale, causal, window, qpg, d = args
    s = qkv.shape[0]
    jqkv = jnp.asarray(_f32(qkv), jnp.float16)
    jkvl = None if kvl is None else jnp.asarray(kvl.numpy(), jnp.int32)
    jseed = None if not rate else jnp.asarray([dseed], jnp.int32)
    jkw = dict(kv_lengths=jkvl, causal=causal, sliding_window=window,
               dropout_rate=rate, dropout_seed=jseed)
    cos = sin = None
    rot = 0
    if rope is not None:
        cos, sin = (jnp.asarray(t.numpy()) for t in rope[:2])
        rot = rope[2]
        jkw["rope_freqs"] = jnp.asarray(
            rope_freqs(0, s, rot, 10000.0).reshape(s, rot).numpy())
    jo = jatt.flash_attention_packed(jqkv, queries_per_group=qpg,
                                     head_dim=d, **jkw)
    return jo, (jqkv, jkvl, cos, sin, jseed), rot


@pytest.mark.parametrize("name", list(PACKED))
def test_packed_fwd_fp16_matches_jax_interpret_kernel(jax_mode, name):
    """o within 1 fp16 ulp plus ``sum_j step(p_j) |v_j|``: the JAX kernel
    rounds the unnormalised dropped p (at most 1 / (1 - rate)) to fp16
    before P V and the plain version keeps it in fp32; divided by l >= 1,
    each such rounding moves o by at most one fp16 step of the normalised
    p (:func:`rounding_step`) times |v|. lse within 1e-4 (both fp32)."""
    jax_mode("interpret")
    case = PACKED[name]
    s, b, g, qpg, d, _ = case
    assert jatt.packed_attention_supported(s, g, qpg, d)
    qkv, do, args = _packed_inputs(case, seed=2)
    jo, _, _ = _jax_packed(qkv, args)
    o, lse = flash_packed_fwd_plain(qkv, *args)
    _, _, _, pd, _ = _packed_bwd_factors(qkv, do, o, lse, *args[:7], qpg, d)
    _, _, v = _qk(qkv, qpg, d, args[1])
    h = g * qpg
    slack = torch.einsum("bhqk,bhkd->bhqd", rounding_step(pd, F16),
                         v.float().abs())
    slack = slack.permute(2, 0, 1, 3).reshape(s, b, h * d)
    _check_fp16("o", _f32(jo), _f32(o), slack.numpy())
    assert o.dtype == F16


def _packed_bwd_run(name, seed, do_scale=1.0, v_scale=1.0):
    """The JAX packed kernel's backward (``_flash_packed_vjp_bwd`` in
    interpret mode) and the port's plain backward in fp16 on the same
    residuals (qkv, do, the JAX forward's o, the port's lse). Returns
    (jax dqkv, port dqkv, slack) as fp32 numpy."""
    case = PACKED[name]
    s, b, g, qpg, d, _ = case
    qkv, do, args = _packed_inputs(case, seed, do_scale, v_scale)
    kvl, rope, dseed, rate, scale, causal, window = args[:7]
    _, lse = flash_packed_fwd_plain(qkv, *args)
    jo, (jqkv, jkvl, cos, sin, jseed), rot = _jax_packed(qkv, args)
    res = (jqkv, jkvl, cos, sin, jseed, jo,
           jnp.asarray(lse.numpy()).reshape(b, g * qpg, 1, s))
    want = jatt._flash_packed_vjp_bwd(scale, causal, window, qpg, d, rot,
                                      rate, res,
                                      jnp.asarray(_f32(do), jnp.float16))[0]
    o = torch.from_numpy(_f32(jo).copy()).half()
    got = flash_packed_bwd_plain(qkv, do, o, lse, *args)
    assert got.dtype == F16
    slack = flash_packed_bwd_rounding_slack(qkv, do, o, lse, *args)
    return _f32(want), _f32(got), slack.numpy()


@pytest.mark.parametrize("name", list(PACKED))
def test_packed_bwd_fp16_matches_jax_interpret_kernel(jax_mode, name):
    """The plain backward rounds ds and the dropped p to fp16 where
    ``_dqkv_packed_kernel`` does: every element of dqkv within 1 fp16 ulp
    plus ``flash_packed_bwd_rounding_slack``, at most 0.1% past 1 ulp."""
    jax_mode("interpret")
    want, got, slack = _packed_bwd_run(name, seed=3)
    _check_fp16("dqkv", want, got, slack, max_past_ulp=1e-3)


@pytest.mark.parametrize("name", ["causal", "kv_lengths_with_zero"])
def test_packed_bwd_fp16_overflow_masks_match_jax(jax_mode, name):
    """do at 2^12 and v at 2^6 (inside fp16's range) make dp = do v^T
    reach ~10^6: ds = p (dp - delta) rounds to inf wherever p is not
    small, and dq and dk take it (inf, or NaN where infs of both signs
    meet). The port's plain backward and the JAX kernel give non-finite
    values at the same elements, which amp's unscale then finds; a row
    with kv_length 0 stays zero."""
    jax_mode("interpret")
    want, got, _ = _packed_bwd_run(name, seed=4, do_scale=2.0 ** 12,
                                   v_scale=2.0 ** 6)
    assert not np.isfinite(want).all()
    assert np.array_equal(np.isfinite(want), np.isfinite(got))
    if name == "kv_lengths_with_zero":
        assert not np.any(got[:, 2])


# ---------------------------------------------------------------------------
# Kernels E's and F's fp16 rounding plans, emulated on the CPU
# ---------------------------------------------------------------------------

def _kernel_e_fp16_emulation(qkv, kv_lengths, seed, rate, scale, causal,
                             split=True, tile=64):
    """Kernel E's fp16 arithmetic for one head (groups 1, qpg 1): an online
    softmax over ``tile``-key tiles, l from the undropped p, the dropped
    fp32 p scaled by 2^(14 - ilogb(1 / (1 - rate))) and split into fp16
    hi + lo (or, with ``split=False``, rounded once to fp16) before P V,
    fp32 sums, o scaled back and rounded once. Returns ``o [s, b, d]``."""
    s, b, w = qkv.shape
    d = w // 3
    t = qkv.reshape(s, b, 3, d).permute(1, 2, 0, 3).float()
    q, k, v = t[:, 0], t[:, 1], t[:, 2]
    kvl = None if kv_lengths is None else torch.as_tensor(kv_lengths)
    valid = _visible(s, s, kvl, causal, None, "cpu")[:, 0]
    keep = None
    inv_keep = float(np.float32(1.0 / (1.0 - rate)))
    if rate:
        combo = drop_combo(torch.arange(b)[:, None, None, None],
                           torch.zeros(1, 1, 1, 1, dtype=torch.long))
        keep = hash_keep(seed, combo, (b, 1, s, s), rate)[:, 0]
    p_scale = 2.0 ** (14 - (math.frexp(inv_keep)[1] - 1))
    m = torch.full((b, s, 1), -1e30)
    l = torch.zeros(b, s, 1)
    acc = torch.zeros(b, s, d)
    for c0 in range(0, s, tile):
        sl = slice(c0, c0 + tile)
        sc = torch.einsum("bqd,bkd->bqk", q, k[:, sl]) * scale
        sc = torch.where(valid[:, :, sl], sc, torch.tensor(-1e30))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.where(sc == -1e30, torch.zeros(()), torch.exp(sc - m_new))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[:, :, sl], p * inv_keep, torch.zeros(()))
        p = p * p_scale
        hi = p.half().float()
        pv = hi @ v[:, sl]
        if split:
            pv = pv + (p - hi).half().float() @ v[:, sl]
        acc = acc * alpha + pv
        m = m_new
    o = acc * torch.where(l > 0, 1.0 / l, torch.zeros(())) / p_scale
    return o.half().permute(1, 0, 2)


E_ROUNDING = {
    # name: (s, b, causal, kv_lengths, rate): one head of the GPT-2
    # training shape, the same with dropout, and kv_lengths with a 0 row
    "gpt2_causal_s1024": (1024, 1, True, None, 0.0),
    "gpt2_causal_s1024_dropout": (1024, 1, True, None, 0.1),
    "kv_lengths_with_zero": (256, 3, False, [256, 100, 0], 0.0),
}


def _e_rounding_inputs(name):
    s, b, causal, kvl, rate = E_ROUNDING[name]
    rng = np.random.RandomState(0)
    qkv = torch.from_numpy(rng.randn(s, b, 192).astype(np.float32)).half()
    seed = -1234567 if rate else None
    kvl_t = None if kvl is None else torch.tensor(kvl)
    return qkv, kvl, seed, rate, causal, (kvl_t, None, seed, rate, 0.125,
                                          causal, None, 1, 64)


@pytest.mark.parametrize("name", list(E_ROUNDING))
def test_kernel_e_fp16_rounding_plan_holds_one_ulp(name):
    """The scaled hi + lo split keeps Kernel E's fp16 o within 1 fp16 ulp
    of the plain version (p in fp32); a row that sees no key is 0."""
    qkv, kvl, seed, rate, causal, args = _e_rounding_inputs(name)
    want, _ = flash_packed_fwd_plain(qkv, *args)
    got = _kernel_e_fp16_emulation(qkv, kvl, seed, rate, 0.125, causal)
    _check_fp16("o", _f32(want), _f32(got.reshape(want.shape)))
    if kvl is not None and 0 in kvl:
        assert not got[:, kvl.index(0)].any()


def test_kernel_e_single_fp16_p_misses_one_ulp():
    """Why the fp16 kernel splits p too: rounded once to fp16 before P V,
    p puts o tens of fp16 ulps from the plain version at s 1024."""
    qkv, kvl, seed, rate, causal, args = _e_rounding_inputs(
        "gpt2_causal_s1024")
    want, _ = flash_packed_fwd_plain(qkv, *args)
    got = _kernel_e_fp16_emulation(qkv, kvl, seed, rate, 0.125, causal,
                                   split=False)
    w, g = _f32(want), _f32(got.reshape(want.shape))
    assert (np.abs(g - w) / _one_ulp(w)).max() > 10


def _kernel_f_fp16_emulation(qkv, do, o, lse, seed, rate, scale, causal,
                             tile=64):
    """Kernel F's fp16 arithmetic for one head (groups 1, qpg 1), as its
    passes order it: delta = rowsum(do * o); the dq pass over
    ``tile``-key tiles and the dk/dv pass over ``tile``-query tiles each
    recompute the fp32 scores and dp, p = 2^((scale s - lse) log2 e),
    the dropout mask, ds = p (dp - delta), and round ds and the dropped p
    to fp16 before their products, summed over tiles in fp32. Returns
    dqkv in the packed layout, rounded to fp16."""
    s, b, w = qkv.shape
    d = w // 3
    t = qkv.reshape(s, b, 3, d).permute(1, 2, 0, 3).float()
    q, k, v = t[:, 0], t[:, 1], t[:, 2]
    rows_of = lambda x: x.reshape(s, b, d).permute(1, 0, 2).float()  # noqa
    dof, of = rows_of(do), rows_of(o)
    delta = (dof * of).sum(-1)
    valid = _visible(s, s, None, causal, None, "cpu")[:, 0]
    keep = None
    if rate:
        combo = drop_combo(torch.arange(b)[:, None, None, None],
                           torch.zeros(1, 1, 1, 1, dtype=torch.long))
        keep = hash_keep(seed, combo, (b, 1, s, s), rate)[:, 0]
    lse = lse[:, 0]

    def factors(rows, cols):
        x = torch.einsum("bqd,bkd->bqk", q[:, rows], k[:, cols]) * scale
        x = torch.where(valid[:, rows, cols], x - lse[:, rows, None],
                        torch.tensor(-1e30))
        p = torch.exp2(x * 1.4426950408889634)
        dp = torch.einsum("bqd,bkd->bqk", dof[:, rows], v[:, cols])
        pd = p
        if keep is not None:
            kp = keep[:, rows, cols]
            dp = torch.where(kp, dp * (1.0 / (1.0 - rate)), torch.zeros(()))
            pd = torch.where(kp, p * (1.0 / (1.0 - rate)), torch.zeros(()))
        ds = p * (dp - delta[:, rows, None])
        return pd.half().float(), ds.half().float()

    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for c0 in range(0, s, tile):                           # the dq pass
        cols = slice(c0, c0 + tile)
        _, ds = factors(slice(0, s), cols)
        dq = dq + ds @ k[:, cols]
    for r0 in range(0, s, tile):                           # the dk/dv pass
        rows = slice(r0, r0 + tile)
        pd, ds = factors(rows, slice(0, s))
        dk = dk + ds.transpose(1, 2) @ q[:, rows]
        dv = dv + pd.transpose(1, 2) @ dof[:, rows]
    out = torch.stack((dq * scale, dk * scale, dv), dim=2)  # [b, s, 3, d]
    return out.permute(1, 0, 2, 3).reshape(s, b, w).half()


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
def test_kernel_f_fp16_rounding_plan_holds_one_ulp(rate):
    """ds and the dropped p formed per 64-wide tile in fp32 and rounded to
    fp16 once each, as Kernel F's fp16 path does, keep dqkv at one head of
    the GPT-2 training shape (s 1024, causal) within 1 fp16 ulp of the
    plain version plus ``flash_packed_bwd_rounding_slack``, with at most
    0.1% of the elements past 1 ulp."""
    s, b = 1024, 1
    rng = np.random.RandomState(4)
    qkv, do = (torch.from_numpy(rng.randn(s, b, n).astype(np.float32))
               .half() for n in (3 * 64, 64))
    seed = -1234567 if rate else None
    args = (None, None, seed, rate, 0.125, True, None, 1, 64)
    o, lse = flash_packed_fwd_plain(qkv, *args)
    want = flash_packed_bwd_plain(qkv, do, o, lse, *args)
    slack = flash_packed_bwd_rounding_slack(qkv, do, o, lse, *args)
    got = _kernel_f_fp16_emulation(qkv, do, o, lse, seed, rate, 0.125, True)
    _check_fp16("dqkv", _f32(want), _f32(got), slack.numpy(),
                max_past_ulp=1e-3)


def test_packed_autograd_keeps_fp16():
    qkv = torch.randn(32, 2, 192).half().requires_grad_()
    o = tatt.flash_attention_packed(qkv, queries_per_group=1, head_dim=64,
                                    causal=True)
    assert o.dtype == F16
    o.float().sum().backward()
    assert qkv.grad.dtype == F16 and torch.isfinite(qkv.grad).all()
