"""fp16 (``torch.float16``) in the port's Kernels A-M, against the JAX
package on the CPU, and the dtype gates of the kernels.

- The gates: ``dtype_code`` takes fp16 with the code of ``kF16`` in
  ``csrc/common.cuh``; the wrappers of Kernels A-M let fp16 through to
  their launch (a stub build stops them there), and refuse float64 with a
  TypeError before any launch.
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
- Kernels G and H: the plain versions in fp16 against ``_fwd_pallas`` and
  ``_bwd_pallas`` in interpret mode (padding masks with fully masked rows,
  a key mask, causal, a row of 200, scale != 1), within 1 fp16 ulp; dy
  scaled past fp16's range, where dx is non-finite at the same elements.
- Kernel C: ``decode_plain`` in fp16 bitwise ``_reference`` (w = 1 and
  windows, a sliding window, fp16 and int8 pools); Kernel C's function
  (the plain version run in f32 and rounded once) within 1 fp16 ulp of
  ``_pallas`` in interpret mode at w = 1, and of ``_reference`` run in f32
  for int8 pools and windows.
- Kernel B: the plain forward in fp16 against the JAX forward in interpret
  mode (``_fwd_single_kernel`` and, with 64-row blocks, ``_fwd_kernel``),
  within E's bar; its fp16 p plan (p scaled by 2^14 and split into hi +
  lo) emulated at the serve prefill's s 768 and at the T5 cross shape,
  within 1 fp16 ulp, where one fp16 p is not.
- Kernel I: the plain backward in fp16 against ``_flash_vjp_bwd`` in
  interpret mode on the same residuals (the single-block kernel at a
  T5-like cross shape with a 0 length; the two-pass kernels causal, and
  with GQA and a window), within 1 fp16 ulp plus
  ``flash_bwd_rounding_slack`` with at most 0.8% of the elements past 1
  ulp (the card's bar); a cotangent scaled so that ds overflows fp16,
  where the non-finite masks agree; the plain backward and the slack
  follow the dtype (ds and p rounded to fp16, steps of 2^-11); and
  Kernel I's fp16 rounding plan emulated at one T5 cross head.
- Kernels J-M: the plain versions in fp16 against the JAX kernels
  (``_fwd_pallas``, ``_bwd_pallas``, ``_c3_fwd_pallas``,
  ``_c3_bwd_pallas``) in interpret mode on the same residuals, with and
  without the input affine and relu: y and dx within 1 fp16 ulp, the fp32
  sums (stats, dW, da, db) within 1e-5 norm-wise; a stats cotangent that
  makes dy_eff overflow fp16, where the non-finite masks agree.

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
from apex_tpu.ops import decode_attention as jda
from apex_tpu.ops import flash_attention as jax_flash
from apex_tpu.ops import layer_norm as jln
from apex_tpu.ops import softmax as jsm
from apex_tpu_torch.ops import _build, _support
from apex_tpu_torch.ops import attention as tatt
from apex_tpu_torch.ops import layer_norm as tln
from apex_tpu_torch.ops.attention import (
    _packed_bwd_factors,
    _qk,
    _visible,
    drop_combo,
    flash_bwd_cuda,
    flash_bwd_factors,
    flash_bwd_plain,
    flash_bwd_rounding_slack,
    flash_fwd_cuda,
    flash_fwd_plain,
    flash_packed_bwd_cuda,
    flash_packed_bwd_plain,
    flash_packed_bwd_rounding_slack,
    flash_packed_fwd_cuda,
    flash_packed_fwd_plain,
    hash_keep,
    rounding_step,
)
from apex_tpu.ops import conv_fused as jcf
from apex_tpu_torch.ops.conv_fused import (
    conv1x1_bn_act,
    conv1x1_bwd_cuda,
    conv1x1_bwd_plain,
    conv1x1_fwd_cuda,
    conv1x1_fwd_plain,
    conv3x3_bn_act,
    conv3x3_bwd_cuda,
    conv3x3_bwd_plain,
    conv3x3_fwd_cuda,
    conv3x3_fwd_plain,
)
from apex_tpu_torch.ops.decode_attention import (
    fused_paged_decode_attention,
    page_pool,
    paged_decode_cuda,
    paged_decode_plan,
    scale_pool,
)
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
from apex_tpu_torch.ops.softmax import (
    scaled_masked_softmax,
    softmax_bwd_cuda,
    softmax_bwd_plain,
    softmax_fwd_cuda,
    softmax_fwd_plain,
    softmax_fwd_plan,
)

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
    assert _support.dtype_code(torch.float16, "X") == codes["kF16"]
    assert _support.dtype_code(torch.bfloat16, "X") == codes["kBF16"]
    assert _support.dtype_code(torch.float32, "X") == codes["kF32"]
    assert set(_support._DTYPE_CODES) == {torch.float32, torch.bfloat16,
                                         torch.float16}
    for dtype in (torch.float64, torch.int32, torch.int8):
        with pytest.raises(TypeError, match=f"Kernel X takes .* got "
                                            f"{dtype}"):
            _support.dtype_code(dtype, "Kernel X")


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


@pytest.mark.parametrize("kernel", sorted(GATED))
def test_kernels_with_fp16_take_it(stub_build, kernel):
    with pytest.raises(_Launched):
        GATED[kernel](F16)
    with pytest.raises(_Launched):
        GATED[kernel](torch.bfloat16)


@pytest.mark.parametrize("kernel", sorted(GATED))
def test_kernels_refuse_float64_before_any_launch(stub_build, kernel):
    before = dict(_support.LAUNCHES)
    with pytest.raises(TypeError, match="float64"):
        GATED[kernel](torch.float64)
    assert _support.LAUNCHES == before


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

def _fwd_fp16_emulation(q, k, v, valid, scale, keep=None, rate=0.0,
                        split=True, tile=64):
    """The fp16 arithmetic of Kernels E and B, one (batch, head) pair per
    row of the leading dimension: q ``[n, sq, d]``, k and v ``[n, sk, d]``,
    ``valid`` ``[n or 1, sq, sk]``, ``keep`` the dropout keep mask or None.
    An online softmax over ``tile``-key tiles, l from the undropped p, the
    dropped fp32 p scaled by 2^(14 - ilogb(1 / (1 - rate))) and split into
    fp16 hi + lo (or, with ``split=False``, rounded once to fp16) before
    P V, fp32 sums, o scaled back and rounded once. Returns ``o [n, sq,
    d]`` in fp16."""
    q, k, v = q.float(), k.float(), v.float()
    n, sq, d = q.shape
    inv_keep = float(np.float32(1.0 / (1.0 - rate)))
    p_scale = 2.0 ** (14 - (math.frexp(inv_keep)[1] - 1))
    m = torch.full((n, sq, 1), -1e30)
    l = torch.zeros(n, sq, 1)
    acc = torch.zeros(n, sq, d)
    for c0 in range(0, k.shape[1], tile):
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
    return (acc * torch.where(l > 0, 1.0 / l, torch.zeros(()))
            / p_scale).half()


def _kernel_e_fp16_emulation(qkv, kv_lengths, seed, rate, scale, causal,
                             split=True, tile=64):
    """Kernel E's fp16 arithmetic (:func:`_fwd_fp16_emulation`) for one
    head (groups 1, qpg 1). Returns ``o [s, b, d]``."""
    s, b, w = qkv.shape
    d = w // 3
    t = qkv.reshape(s, b, 3, d).permute(1, 2, 0, 3)
    kvl = None if kv_lengths is None else torch.as_tensor(kv_lengths)
    valid = _visible(s, s, kvl, causal, None, "cpu")[:, 0]
    keep = None
    if rate:
        combo = drop_combo(torch.arange(b)[:, None, None, None],
                           torch.zeros(1, 1, 1, 1, dtype=torch.long))
        keep = hash_keep(seed, combo, (b, 1, s, s), rate)[:, 0]
    o = _fwd_fp16_emulation(t[:, 0], t[:, 1], t[:, 2], valid, scale, keep,
                            rate, split, tile)
    return o.permute(1, 0, 2)


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


# ---------------------------------------------------------------------------
# Kernels G and H: plain versions in fp16 against the JAX interpret kernels
# ---------------------------------------------------------------------------

SOFTMAX = {
    # name: (x shape, mask: None | "padding" | mask shape, causal, scale):
    # a BERT padding mask (its padded query rows mask every key), a key
    # mask, causal, a row of 200, scale != 1, rows of 64 (Kernel G's
    # 16-byte path on the card)
    "bert_padding": ((2, 3, 20, 20), "padding", False, 1.0),
    "key_mask_k200": ((2, 3, 10, 200), (2, 1, 1, 200), False, 1.0),
    "causal": ((1, 2, 24, 24), None, True, 1.0),
    "scale_half": ((2, 2, 8, 33), (2, 1, 8, 33), False, 0.5),
    "rows_of_64": ((2, 3, 16, 64), (2, 1, 16, 64), False, 0.125),
}


def _softmax_inputs(name, seed, dy_scale=1.0):
    """fp16 x and dy ``[d0, d1, d2, k]`` (numpy-made), the bool mask (True
    = masked out) or None, causal, scale."""
    shape, mask, causal, scale = SOFTMAX[name]
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((3.0 * rng.randn(*shape)).astype(np.float32)).half()
    dy = torch.from_numpy((rng.randn(*shape) * dy_scale).astype(
        np.float32)).half()
    if mask == "padding":
        valid = np.ones((shape[0], shape[-1]), bool)
        valid[1, 13:] = False
        mask = ~(valid[:, None, None, :] & valid[:, None, :, None])
    elif mask is not None:
        mask = rng.rand(*mask) < 0.3
    return x, dy, None if mask is None else torch.from_numpy(mask), causal, \
        scale


def _jax_softmax(x, dy, mask, causal, scale, y=None):
    """``_fwd_pallas`` and ``_bwd_pallas`` over the rows of the fp16 x and
    dy (the backward on ``y``, the JAX forward's y by default): fp16
    ``(y, dx)`` as fp32 numpy ``[rows, k]``."""
    k, sq = x.shape[-1], x.shape[-2]
    x2 = jnp.asarray(_f32(x), jnp.float16).reshape(-1, k)
    m2 = None if mask is None else jnp.broadcast_to(
        jnp.asarray(mask.numpy()), x.shape).reshape(-1, k)
    jy = jsm._fwd_pallas(x2, m2, scale, k, sq, causal, jnp.float16)
    jy_in = jy if y is None else jnp.asarray(_f32(y), jnp.float16)
    jdx = jsm._bwd_pallas(jnp.asarray(_f32(dy), jnp.float16).reshape(-1, k),
                          jy_in.reshape(-1, k), scale, k)
    assert jy.dtype == jnp.float16 and jdx.dtype == jnp.float16
    return _f32(jy), _f32(jdx)


@pytest.mark.parametrize("name", list(SOFTMAX))
def test_softmax_fp16_matches_jax_interpret_kernels(jax_mode, name,
                                                    record_property):
    """y and dx of the plain versions in fp16 within 1 fp16 ulp of the TPU
    kernels in interpret mode (each side computes in fp32 and rounds once);
    dx on the JAX forward's y, so that only H's arithmetic differs. A fully
    masked row is uniform, 1/k. How many elements differ at all is
    recorded (``elements_differing``, junit properties)."""
    jax_mode("interpret")
    x, dy, mask, causal, scale = _softmax_inputs(name, seed=5)
    k = x.shape[-1]
    want_y, want_dx = _jax_softmax(x, dy, mask, causal, scale)
    y = softmax_fwd_plain(x, mask, scale, x.shape[-2], causal)
    assert y.dtype == F16
    _check_fp16("y", want_y, _f32(y).reshape(-1, k))
    dx = softmax_bwd_plain(dy.reshape(-1, k),
                           torch.from_numpy(want_y).half(), scale)
    assert dx.dtype == F16
    _check_fp16("dx", want_dx, _f32(dx))
    record_property("elements_differing", {
        "y": int((_f32(y).reshape(-1, k) != want_y).sum()),
        "dx": int((_f32(dx) != want_dx).sum()), "of": y.numel()})
    if name == "bert_padding":
        rows = _f32(y)[1, :, 13:]            # padded query rows: all masked
        assert np.all(rows == np.float32(np.float16(1.0 / k)))


@pytest.mark.parametrize("name", ["bert_padding", "key_mask_k200"])
def test_softmax_bwd_fp16_overflow_masks_match_jax(jax_mode, name):
    """dy at 2^15, as an overflowing loss scale leaves it (inf in fp16
    where |dy| passes 65504), and H's scale 8: dx = scale y (dy - s) is NaN
    across a row whose s met an inf and inf wherever it passes 65504, on
    both sides at the same elements. (With dy at 2^12 nothing overflows
    here: y (dy - s) peaks where y is near 1/2, at a quarter of dy's
    spread.) The finite elements, scaled back by 2^15 (exact), within 1
    fp16 ulp."""
    jax_mode("interpret")
    x, dy, mask, causal, _ = _softmax_inputs(name, seed=6,
                                             dy_scale=2.0 ** 15)
    k = x.shape[-1]
    y = softmax_fwd_plain(x, mask, 1.0, x.shape[-2], causal)
    _, want = _jax_softmax(x, dy, mask, causal, 8.0, y=y)
    got = _f32(softmax_bwd_plain(dy.reshape(-1, k), y.reshape(-1, k), 8.0))
    assert not np.isfinite(want).all()
    assert np.array_equal(np.isfinite(want), np.isfinite(got))
    fin = np.isfinite(want)
    _check_fp16("dx finite", np.where(fin, want, 0) / 2 ** 15,
                np.where(fin, got, 0) / 2 ** 15)


def test_softmax_autograd_keeps_fp16():
    x, dy, mask, _, _ = _softmax_inputs("bert_padding", seed=7)
    x.requires_grad_()
    y = scaled_masked_softmax(x, mask, 0.5)
    assert y.dtype == F16
    y.backward(dy)
    assert x.grad.dtype == F16 and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("k", [8, 64, 512, 1000, 1024])
def test_kernel_g_plan_takes_fp16_rows_as_bf16(k):
    """Kernel G's 16-byte path takes fp16 rows as it takes bf16 ones (8
    elements a piece); f32 and off-size rows keep the element path."""
    bert = (0, 0, k, 1)
    assert softmax_fwd_plan(k, F16, 0, 0, 0, bert) == \
        softmax_fwd_plan(k, torch.bfloat16, 0, 0, 0, bert) != (0, 0)
    assert softmax_fwd_plan(k + 1, F16, 0, 0) == (0, 0)
    assert softmax_fwd_plan(k, torch.float32, 0, 0) == (0, 0)


# ---------------------------------------------------------------------------
# Kernel C: paged decode in fp16 against the JAX reference and kernel
# ---------------------------------------------------------------------------

C_PAGES, C_PS, C_PPS = 12, 8, 5
C_B, C_KVH, C_GROUP, C_DH = 5, 2, 4, 16
C_F = C_KVH * C_DH
#: each slot's position: a ragged last page, a slot's first row, the last
#: row of its third page, a sentinel page (its row drops), past the table
C_POSITIONS = np.array([13, 0, 22, 20, 38], np.int32)


def _decode_inputs(w, seed):
    """fp16-valued f32 numpy inputs: q ``[b, w, heads, dh]``, the new rows
    ``[b, w, f]``, pools, a page table with sentinels, positions."""
    rng = np.random.RandomState(seed)
    r16 = lambda *s: rng.randn(*s).astype(np.float16).astype(  # noqa: E731
        np.float32)
    table = np.full((C_B, C_PPS), C_PAGES, np.int32)
    table[0, :2] = [4, 9]
    table[1, :1] = [0]
    table[2, :3] = [2, 7, 11]
    table[3, :2] = [1, 3]
    table[4, :] = [5, 6, 8, 10, 1]
    return (r16(C_B, w, C_KVH * C_GROUP, C_DH), r16(C_B, w, C_F),
            r16(C_B, w, C_F), r16(C_PAGES, C_PS, C_F),
            r16(C_PAGES, C_PS, C_F), table, C_POSITIONS)


def _quantize(pages, seed):
    """An int8 pool and per-(page, kv head) scales as a page fill makes
    them (a quarter of the pages at scale 0, as free pages are)."""
    rng = np.random.RandomState(seed)
    p4 = pages.reshape(C_PAGES, C_PS, C_KVH, C_DH)
    scales = (np.abs(p4).max(axis=(1, 3)) / 127.0).astype(np.float32)
    scales[rng.rand(C_PAGES) < 0.25] = 0.0
    safe = np.where(scales > 0, scales, 1.0)[:, None, :, None]
    q8 = np.clip(np.round(p4 / safe), -127, 127).astype(np.int8)
    return q8.reshape(C_PAGES, C_PS, C_F), scales


def _pools(args, int8, dtype):
    """The port's pools (with their spare page) and scales, or JAX's."""
    _, _, _, kp, vp, _, _ = args
    if int8:
        (k8, ks), (v8, vs) = _quantize(kp, 0), _quantize(vp, 1)
        if dtype is None:
            return (jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(ks),
                    jnp.asarray(vs))
        pools = []
        for a, sc in ((k8, ks), (v8, vs)):
            pool = page_pool(C_PAGES, C_PS, C_F, torch.int8, "cpu")
            pool.copy_(torch.from_numpy(a))
            scs = scale_pool(C_PAGES, C_KVH, "cpu")
            scs.copy_(torch.from_numpy(sc))
            pools.append((pool, scs))
        (kq, ksc), (vq, vsc) = pools
        return kq, vq, ksc, vsc
    if dtype is None:
        return None
    out = []
    for a in (kp, vp):
        pool = page_pool(C_PAGES, C_PS, C_F, dtype, "cpu")
        pool.copy_(torch.from_numpy(a))
        out.append(pool)
    return out[0], out[1], None, None


def _port_decode(args, window, int8, dtype):
    """``fused_paged_decode_attention`` on the CPU in ``dtype`` (the append
    and ``decode_plain``): the context ``[b, w, heads * dh]`` as fp32
    numpy."""
    q, k_new, v_new, _, _, table, positions = args
    kp, vp, ks, vs = _pools(args, int8, dtype)
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    out = fused_paged_decode_attention(
        t(q), t(k_new), t(v_new), kp, vp, torch.from_numpy(table),
        torch.from_numpy(positions), queries_per_group=C_GROUP,
        sliding_window=window, k_scales=ks, v_scales=vs)
    assert out[0].dtype == dtype
    return _f32(out[0])


def _jax_decode(args, window, int8, dtype, kernel=False):
    """JAX's ``_reference`` (or, with ``kernel``, ``_pallas``) in
    ``dtype``: the context as fp32 numpy."""
    q, k_new, v_new, kp, vp, table, positions = args
    a = lambda x: jnp.asarray(x, dtype)  # noqa: E731
    pools = _pools(args, int8, None) or (a(kp), a(vp), None, None)
    fn = jda._pallas if kernel else jda._reference
    out = fn(a(q), a(k_new), a(v_new), *pools, jnp.asarray(table),
             jnp.asarray(positions), C_GROUP, window)
    assert out[0].dtype == dtype
    return _f32(out[0])


@pytest.mark.parametrize("int8", [False, True], ids=["fp16_pools", "int8"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("w", [1, 4])
def test_decode_fp16_plain_matches_reference(jax_mode, record_property, w,
                                             window, int8):
    """In fp16 ``decode_plain`` rounds where ``_reference`` does (the score
    GEMM in q's dtype, int8 pages dequantized to q's dtype, p rounded
    before ``p v``), so the contexts are equal bit for bit but where a
    score's fp32 sum lies on a rounding boundary: torch's and XLA's fp16
    GEMMs on the CPU both sum in fp32, in other orders, and round such a
    score to neighbouring fp16 values (a probe of random [5, 40, 32] x [5,
    32, 8] products: 24 of 32,000 elements), which moves its row's context
    by up to 2 fp16 ulps. Held: at most 1.5% of the elements differ, each
    within 2 fp16 ulps (over seeds 11-15 and these eight cases: 2 of 40
    runs differ, at 7 of 640 and 9 of 2,560 elements, 1.94 ulps at most);
    the count is recorded (``elements_differing``)."""
    jax_mode("off")
    args = _decode_inputs(w, seed=11)
    got = _port_decode(args, window, int8, F16)
    want = _jax_decode(args, window, int8, jnp.float16)
    record_property("elements_differing", int((got != want).sum()))
    assert (got != want).mean() <= 0.015
    assert (np.abs(got - want) <= 2 * _one_ulp(want)).all()


@pytest.mark.parametrize("window", [None, 6])
def test_decode_fp16_kernel_function_matches_interpret_kernel(jax_mode,
                                                              window):
    """What Kernel C computes in fp16 (scores and p in fp32, the context
    rounded once: the plain version run in f32 on the fp16 values, then
    rounded to fp16) within 1 fp16 ulp of the TPU kernel in interpret mode
    on the same fp16 inputs, w = 1 over fp16 pools."""
    jax_mode("interpret")
    args = _decode_inputs(1, seed=12)
    want = _jax_decode(args, window, False, jnp.float16, kernel=True)
    got = _f32(torch.from_numpy(_port_decode(args, window, False,
                                             torch.float32)).half())
    _check_fp16("ctx", want, got)


@pytest.mark.parametrize("int8,w", [(True, 1), (False, 4), (True, 4)],
                         ids=["int8", "w4", "int8_w4"])
def test_decode_fp16_kernel_function_matches_reference(jax_mode, int8, w):
    """Kernel C's function in fp16 with int8 pools (dequantized in fp32)
    and w-row windows (GQA 4, a sliding window): the plain version run in
    f32 on the fp16 values and rounded once, within 1 fp16 ulp of
    ``_reference`` run in f32 and rounded once (summation order only)."""
    jax_mode("off")
    args = _decode_inputs(w, seed=13)
    got = _f32(torch.from_numpy(_port_decode(args, 6, int8,
                                             torch.float32)).half())
    want = _f32(torch.from_numpy(_jax_decode(args, 6, int8,
                                             jnp.float32)).half())
    _check_fp16("ctx", want, got)


@pytest.mark.parametrize("pool", ["float16", "int8"])
def test_decode_plan_takes_fp16_as_bf16(pool):
    """fp16 q takes Kernel C's vector path with the plan bf16 gets: 8
    elements a 16-byte piece, pools in q's dtype or int8."""
    pool_dtype = getattr(torch, pool)
    plans = [paged_decode_plan(
        8, 12, 12, 64, 64, 12, dt, True, lambda p, h: 2, 132, None,
        window=4, pool_dtype=pool_dtype if pool == "int8" else dt)
        for dt in (F16, torch.bfloat16)]
    assert plans[0] == plans[1] and plans[0].path == "vector"
    assert paged_decode_plan(8, 12, 12, 60, 64, 12, F16, True,
                             lambda p, h: 2, 132).path == "element"


# ---------------------------------------------------------------------------
# Kernel B: the plain forward in fp16 against the JAX interpret kernels, and
# its fp16 p plan emulated on the CPU
# ---------------------------------------------------------------------------

B_INTERPRET = {
    # name: ((b, h, kvh, sq, sk, d, causal, kv_lengths, window), blocks):
    # the multi-block `_fwd_kernel` over 64-row tiles (causal GQA with
    # kv_lengths, a sliding window), the single-block `_fwd_single_kernel`
    # (causal; kv_lengths with a 0 row; the sk - sq offset)
    "multi_causal_gqa_kvl": ((1, 8, 2, 160, 160, 64, True, [150], None),
                             dict(block_q=64, block_k=64)),
    "multi_window": ((1, 4, 4, 160, 160, 64, True, None, 40),
                     dict(block_q=64, block_k=64)),
    "single_causal": ((2, 4, 4, 48, 48, 64, True, None, None), {}),
    "single_kv_lengths_with_zero": ((3, 2, 2, 40, 40, 64, False, [40, 17, 0],
                                     None), {}),
    "single_sq_lt_sk": ((1, 4, 2, 24, 100, 64, True, None, None), {}),
}


def _b_inputs(case, seed):
    b, h, kvh, sq, sk, d, causal, kvl, window = case
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).half()
               for s in ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d)))
    kvl = None if kvl is None else torch.tensor(kvl, dtype=torch.int32)
    return q, k, v, (kvl, 1.0 / math.sqrt(d), causal, window)


@pytest.mark.parametrize("name", list(B_INTERPRET))
def test_flash_fwd_fp16_matches_jax_interpret_kernels(jax_mode, name):
    """o of the plain forward in fp16 within 1 fp16 ulp plus ``sum_j
    step(p_j) |v_j|`` of the JAX kernels in interpret mode: they round the
    unnormalised p to fp16 before P V, the plain version keeps it in fp32
    (E's bar). A row that sees no key is 0 on both sides."""
    jax_mode("interpret")
    case, blocks = B_INTERPRET[name]
    q, k, v, args = _b_inputs(case, seed=8)
    kvl, scale, causal, window = args
    jkvl = None if kvl is None else jnp.asarray(kvl.numpy())
    want = jax_flash(*(jnp.asarray(_f32(t), jnp.float16) for t in (q, k, v)),
                     causal=causal, sliding_window=window, kv_lengths=jkvl,
                     **blocks)
    assert want.dtype == jnp.float16
    o, lse = flash_fwd_plain(q, k, v, *args)
    assert o.dtype == F16
    p, _ = flash_bwd_factors(q, k, v, o, o, lse, *args)
    group = q.shape[1] // k.shape[1]
    slack = torch.einsum("bhqk,bhkd->bhqd", rounding_step(p, F16),
                         v.float().abs().repeat_interleave(group, dim=1))
    _check_fp16("o", _f32(want), _f32(o), slack.numpy())


def _kernel_b_fp16_emulation(q, k, v, kv_lengths, scale, causal, window,
                             split=True):
    """Kernel B's fp16 arithmetic (:func:`_fwd_fp16_emulation`, no
    dropout: p scaled by 2^14) over ``[b, h, s, d]`` with GQA: ``o [b, h,
    sq, d]``."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    valid = _visible(sq, sk, kv_lengths, causal, window, "cpu").expand(
        b, h, sq, sk).reshape(b * h, sq, sk)
    group = h // k.shape[1]
    kv = lambda t: t.repeat_interleave(group, dim=1).reshape(  # noqa: E731
        b * h, sk, d)
    o = _fwd_fp16_emulation(q.reshape(b * h, sq, d), kv(k), kv(v), valid,
                            scale, split=split)
    return o.reshape(b, h, sq, d)


B_ROUNDING = {
    # name: (b, h, kvh, sq, sk, d, causal, kv_lengths, window): two heads
    # of the serve prefill at its largest bucket, the T5 cross-attention
    # (one head, kv_lengths with a 0), a window with the sk - sq offset
    "serve_s768": (1, 2, 2, 768, 768, 64, True, None, None),
    "t5_cross_one_head": (3, 1, 1, 114, 512, 64, False, [512, 300, 0],
                          None),
    "window_offset_gqa": (1, 4, 2, 160, 300, 64, True, [280], 64),
}


@pytest.mark.parametrize("name", list(B_ROUNDING))
def test_kernel_b_fp16_rounding_plan_holds_one_ulp(name):
    """The scaled hi + lo split keeps Kernel B's fp16 o within 1 fp16 ulp
    of the plain version (p in fp32); a row that sees no key is 0."""
    q, k, v, args = _b_inputs(B_ROUNDING[name], seed=9)
    want, _ = flash_fwd_plain(q, k, v, *args)
    got = _kernel_b_fp16_emulation(q, k, v, *args)
    _check_fp16("o", _f32(want), _f32(got))
    kvl = args[0]
    if kvl is not None and 0 in kvl.tolist():
        assert not got[kvl.tolist().index(0)].any()


def test_kernel_b_single_fp16_p_misses_one_ulp():
    """Why Kernel B splits p in fp16 too: rounded once to fp16 before P V,
    p puts o at the serve prefill's s 768 tens of fp16 ulps from the plain
    version (29.7 on these inputs; the split plan: 0.97)."""
    q, k, v, args = _b_inputs(B_ROUNDING["serve_s768"], seed=9)
    want, _ = flash_fwd_plain(q, k, v, *args)
    got = _kernel_b_fp16_emulation(q, k, v, *args, split=False)
    w, g = _f32(want), _f32(got)
    assert (np.abs(g - w) / _one_ulp(w)).max() > 10


def test_flash_autograd_forward_keeps_fp16():
    q, k, v, (kvl, _, causal, window) = _b_inputs(
        B_INTERPRET["single_causal"][0], seed=10)
    o = tatt.flash_attention(q, k, v, causal=causal, kv_lengths=kvl)
    assert o.dtype == F16 and torch.isfinite(o).all()


# ---------------------------------------------------------------------------
# Kernel I: the plain backward in fp16 against the JAX interpret kernels, and
# its fp16 rounding plan emulated on the CPU
# ---------------------------------------------------------------------------

I_INTERPRET = {
    # name: ((b, h, kvh, sq, sk, d, causal, kv_lengths, window), blocks):
    # the single-block `_dqkv_single_kernel` at a T5-like cross-attention
    # (kv_lengths with a 0 row), the two-pass `_dq_kernel` + `_dkv_kernel`
    # over 64-row blocks causal with the sk - sq offset, and with GQA and a
    # sliding window
    "t5_cross_kv_lengths_zero": ((3, 2, 2, 38, 128, 64, False, [128, 70, 0],
                                  None), {}),
    "causal_offset": ((1, 4, 4, 72, 130, 64, True, None, None),
                      dict(block_q=64, block_k=64)),
    "gqa_window": ((1, 8, 2, 160, 160, 64, True, None, 40),
                   dict(block_q=64, block_k=64)),
}


def _i_inputs(case, seed, do_scale=1.0, v_scale=1.0):
    """fp16 q, k, v (times ``v_scale``) and do (times ``do_scale``), the
    port's forward residuals o and lse, and ``(kv_lengths, scale, causal,
    window)``."""
    q, k, v, args = _b_inputs(case, seed)
    rng = np.random.RandomState(seed + 100)
    v = (v.float() * v_scale).half()
    do = torch.from_numpy((rng.randn(*q.shape) * do_scale).astype(
        np.float32)).half()
    o, lse = flash_fwd_plain(q, k, v, *args)
    return q, k, v, do, o, lse, args


def _i_run(name, seed, do_scale=1.0, v_scale=1.0):
    """The JAX kernels' backward (``_flash_vjp_bwd`` in interpret mode) and
    the port's plain backward in fp16 on the same residuals (the port's o
    and lse): (jax, port, slack) as lists of fp32 numpy (dq, dk, dv)."""
    case, blocks = I_INTERPRET[name]
    q, k, v, do, o, lse, args = _i_inputs(case, seed, do_scale, v_scale)
    kvl, scale, causal, window = args
    sq, sk = q.shape[2], k.shape[2]
    block_q, block_k = jatt._auto_blocks(blocks.get("block_q"),
                                         blocks.get("block_k"), sk)
    bq = min(block_q, jatt.round_up(sq, 8))
    bk = min(block_k, jatt.round_up(sk, 128))
    j16 = lambda t: jnp.asarray(_f32(t), jnp.float16)  # noqa: E731
    res = (j16(q), j16(k), j16(v),
           None if kvl is None else jnp.asarray(kvl.numpy()), j16(o),
           jnp.asarray(lse.numpy()))
    want = jatt._flash_vjp_bwd(scale, causal, bq, bk, window, res,
                               j16(do))[:3]
    assert all(t.dtype == jnp.float16 for t in want)
    got = flash_bwd_plain(q, k, v, do, o, lse, *args)
    assert all(t.dtype == F16 for t in got)
    slack = flash_bwd_rounding_slack(q, k, v, do, o, lse, *args)
    return ([_f32(t) for t in want], [_f32(t) for t in got],
            [t.numpy() for t in slack])


@pytest.mark.parametrize("name", list(I_INTERPRET))
def test_flash_bwd_fp16_matches_jax_interpret_kernels(jax_mode, name):
    """Both round ds and p to fp16 where the JAX kernels do: dq, dk and dv
    within 1 fp16 ulp plus ``flash_bwd_rounding_slack``, at most 0.8% of
    the elements past 1 ulp (the card's fp16 bar: against the same fp32
    differences, fp16's 2^3 finer spacing puts 2^3 bf16's share of ds on a
    rounding boundary); a batch row with kv_length 0 gets zero
    gradients."""
    jax_mode("interpret")
    want, got, slack = _i_run(name, seed=11)
    for n, w, g, sl in zip(("dq", "dk", "dv"), want, got, slack):
        _check_fp16(n, w, g, sl, max_past_ulp=8e-3)
    kvl = I_INTERPRET[name][0][7]
    if kvl is not None and 0 in kvl:
        assert not any(g[kvl.index(0)].any() for g in got)


@pytest.mark.parametrize("name", ["t5_cross_kv_lengths_zero"])
def test_flash_bwd_fp16_overflow_masks_match_jax(jax_mode, name):
    """do at 2^12 and v at 2^6 make dp = do v^T reach ~10^6: ds rounds to
    inf in fp16 wherever p is not small, and dq and dk take it (inf, or
    NaN where infs of both signs meet), as do the dv of rows whose p
    times do passes 65504. The plain backward and the JAX kernels give
    non-finite values at the same elements; a row with kv_length 0 stays
    zero."""
    jax_mode("interpret")
    want, got, _ = _i_run(name, seed=12, do_scale=2.0 ** 12,
                          v_scale=2.0 ** 6)
    assert not np.isfinite(want[0]).all()
    for w, g in zip(want, got):
        assert np.array_equal(np.isfinite(w), np.isfinite(g))
    kvl = I_INTERPRET[name][0][7]
    if kvl is not None and 0 in kvl:
        assert not any(g[kvl.index(0)].any() for g in got)


def test_flash_bwd_plain_and_slack_follow_fp16():
    """In fp16 the plain backward rounds ds and p to fp16 (not bf16)
    before their products, and the slack counts fp16 steps: 2^-11 of
    |ds| and |p|, at least fp16's subnormal spacing 2^-24."""
    case, _ = I_INTERPRET["t5_cross_kv_lengths_zero"]
    q, k, v, do, o, lse, args = _i_inputs(case, seed=13)
    scale = args[1]
    p, ds = flash_bwd_factors(q, k, v, do, o, lse, *args)
    group = q.shape[1] // k.shape[1]
    kr = k.float().repeat_interleave(group, dim=1)
    dq, dk, dv = flash_bwd_plain(q, k, v, do, o, lse, *args)
    want = (scale * torch.einsum("bhqk,bhkd->bhqd", ds.half().float(),
                                 kr)).half()
    assert torch.equal(dq, want)
    slack = flash_bwd_rounding_slack(q, k, v, do, o, lse, *args)
    step = torch.clamp_min(ds.abs() * 2.0 ** -11, 2.0 ** -24)
    torch.testing.assert_close(
        slack[0], scale * torch.einsum("bhqk,bhkd->bhqd", step, kr.abs()),
        rtol=1e-6, atol=0)
    b, kvh, sk, d = k.shape
    pstep = torch.clamp_min(p.abs() * 2.0 ** -11, 2.0 ** -24)
    want_dv = torch.einsum("bhqk,bhqd->bhkd", pstep, do.float().abs())
    torch.testing.assert_close(
        slack[2], want_dv.reshape(b, kvh, group, sk, d).sum(2), rtol=1e-6,
        atol=0)


def _kernel_i_fp16_emulation(q, k, v, do, o, lse, kv_lengths, scale,
                             causal, window, tile=64):
    """Kernel I's fp16 arithmetic over ``[b, h, s, d]``: delta =
    rowsum(do * o); the dq pass over ``tile``-key tiles and the dk/dv pass
    over ``tile``-query tiles each recompute the fp32 scores and dp, p =
    2^((scale s - lse) log2 e) (0 where masked), ds = p (dp - delta), and
    round ds and p to fp16 before their products, summed over tiles in
    fp32; dk and dv summed over a group's query heads before the one
    rounding. Returns ``(dq, dk, dv)`` in fp16."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    group = h // kvh
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    delta = (dof * o.float()).sum(-1)
    valid = _visible(sq, sk, kv_lengths, causal, window, "cpu")

    def factors(rows, cols):
        x = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, rows],
                         kf[:, :, cols]) * scale
        x = torch.where(valid[:, :, rows, cols], x - lse[:, :, rows, None],
                        torch.tensor(-1e30))
        p = torch.exp2(x * 1.4426950408889634)
        dp = torch.einsum("bhqd,bhkd->bhqk", dof[:, :, rows], vf[:, :, cols])
        ds = p * (dp - delta[:, :, rows, None])
        return p.half().float(), ds.half().float()

    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for c0 in range(0, sk, tile):                          # the dq pass
        cols = slice(c0, c0 + tile)
        _, ds = factors(slice(0, sq), cols)
        dq = dq + ds @ kf[:, :, cols]
    for r0 in range(0, sq, tile):                          # the dk/dv pass
        rows = slice(r0, r0 + tile)
        p, ds = factors(rows, slice(0, sk))
        dk = dk + ds.transpose(2, 3) @ qf[:, :, rows]
        dv = dv + p.transpose(2, 3) @ dof[:, :, rows]
    grp = lambda t: t.reshape(b, kvh, group, sk, d).sum(2)  # noqa: E731
    return ((dq * scale).half(), grp(dk * scale).half(), grp(dv).half())


def test_kernel_i_fp16_rounding_plan_holds_one_ulp():
    """ds and p formed per 64-wide tile in fp32 and rounded to fp16 once
    each, as Kernel I's fp16 path does, keep dq, dk and dv at one head of
    the T5 cross-attention (114 queries over 512 keys, kv_lengths with a
    0 row) within 1 fp16 ulp of the plain version plus
    ``flash_bwd_rounding_slack``, with at most 0.1% of the elements past
    1 ulp; the row with kv_length 0 gets zero gradients."""
    q, k, v, args = _b_inputs(B_ROUNDING["t5_cross_one_head"], seed=14)
    rng = np.random.RandomState(15)
    do = torch.from_numpy(rng.randn(*q.shape).astype(np.float32)).half()
    o, lse = flash_fwd_plain(q, k, v, *args)
    want = flash_bwd_plain(q, k, v, do, o, lse, *args)
    slack = flash_bwd_rounding_slack(q, k, v, do, o, lse, *args)
    got = _kernel_i_fp16_emulation(q, k, v, do, o, lse, *args)
    for n, w, g, sl in zip(("dq", "dk", "dv"), want, got, slack):
        _check_fp16(n, _f32(w), _f32(g), sl.numpy(), max_past_ulp=1e-3)
    assert not any(g[2].any() for g in got)


def test_flash_autograd_backward_keeps_fp16():
    q, k, v, (kvl, _, causal, window) = _b_inputs(
        B_INTERPRET["single_kv_lengths_with_zero"][0], seed=16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = tatt.flash_attention(q, k, v, causal=causal, kv_lengths=kvl)
    o.float().sum().backward()
    for t in (q, k, v):
        assert t.grad.dtype == F16 and torch.isfinite(t.grad).all()
    assert not q.grad[2].any() and not k.grad[2].any()


# ---------------------------------------------------------------------------
# Kernels J-M: the plain versions in fp16 against the JAX interpret kernels
# ---------------------------------------------------------------------------

#: kind -> (x shape, w shape, JAX forward and backward kernels, the port's
#: plain forward and backward): a 1x1 over a ragged row count (M = 200) and
#: a 3x3 over three odd-sized images, as tests/test_torch_conv_fused.py
CONV16 = {
    "1x1": ((200, 64), (64, 96), jcf._fwd_pallas, jcf._bwd_pallas,
            conv1x1_fwd_plain, conv1x1_bwd_plain),
    "3x3": ((3, 5, 9, 16), (3, 3, 16, 32), jcf._c3_fwd_pallas,
            jcf._c3_bwd_pallas, conv3x3_fwd_plain, conv3x3_bwd_plain),
}


def _conv16_inputs(kind, affine, seed, dy_scale=1.0, ds1_scale=0.01):
    """fp16 x, w and dy (times ``dy_scale``); fp32 a, b (with the affine),
    the shift c and the stats cotangent ds (its ds1 row times
    ``ds1_scale``)."""
    x_shape, w_shape = CONV16[kind][:2]
    rng = np.random.RandomState(seed)
    k, n = w_shape[-2], w_shape[-1]
    fan_in = int(np.prod(w_shape[:-1]))
    x = torch.from_numpy(rng.randn(*x_shape).astype(np.float32)).half()
    w = torch.from_numpy((rng.randn(*w_shape) * fan_in ** -0.5).astype(
        np.float32)).half()
    a = torch.from_numpy((rng.rand(k) + 0.5).astype(np.float32))
    b = torch.from_numpy(rng.randn(k).astype(np.float32))
    c = torch.from_numpy((0.1 * rng.randn(n)).astype(np.float32))
    dy = torch.from_numpy((dy_scale * rng.randn(*x_shape[:-1], n)).astype(
        np.float32)).half()
    ds = np.stack([0.01 * rng.randn(n), ds1_scale * rng.randn(n)])
    ds = torch.from_numpy(ds.astype(np.float32))
    if not affine:
        a = b = None
    return x, w, a, b, c, dy, ds


def _conv16_slack(kind, x, a, b, w, c, y, dy, ds, affine, relu):
    """How far one fp16 rounding step of each z and each dy_eff can move y
    and dx: ``sum step(z) |w|`` and ``sum step(dy_eff) |w|^T |a|`` in fp32
    (the plain versions run on the steps, in fp32, with no relu mask).
    XLA on the CPU contracts the JAX kernels' ``x * a + b`` into one fused
    multiply-add (the last fp32 bit of about a quarter of z differs from
    two roundings), and the port, like the CUDA kernels, rounds twice, as
    the JAX source writes it: a z or dy_eff on an fp16 rounding boundary
    may then round to neighbouring values on the two sides."""
    _, _, _, _, pfwd, pbwd = CONV16[kind]
    x32, w32, y32 = x.float(), w.float().abs(), y.float()
    z = x32 if not affine else x32 * a + b
    if relu:
        z = z.clamp_min(0.0)
    zero = torch.zeros_like(c)
    y_slack, _ = pfwd(rounding_step(z, F16), None, None, w32, zero, False,
                      False)
    d = (dy.float() + ds[0]) + 2.0 * (y32 - c) * ds[1]
    dx_slack, _, _ = pbwd(x32, a.abs() if affine else None,
                          b if affine else None, w32, c,
                          torch.zeros_like(y32), rounding_step(d, F16),
                          torch.zeros_like(ds), affine, False)
    return y_slack.numpy(), dx_slack.numpy()


def _conv16_run(kind, affine, relu, seed, **scales):
    """The JAX kernels in interpret mode and the port's plain versions on
    the same fp16 inputs, the backward of both on JAX's y: ``(jax, port,
    slack)``, the first two lists of fp32 numpy ``(y, stats, dx, dw,
    dab)`` (dab None without the affine), the slack of y and dx
    (:func:`_conv16_slack`)."""
    _, _, jfwd, jbwd, pfwd, pbwd = CONV16[kind]
    x, w, a, b, c, dy, ds = _conv16_inputs(kind, affine, seed, **scales)
    j = lambda t: jnp.asarray(_f32(t), t.dtype == F16 and jnp.float16  # noqa
                              or jnp.float32)
    zeros = jnp.zeros((1,), jnp.float32)
    ja, jb = (j(a), j(b)) if affine else (zeros, zeros)
    jx = j(x).reshape(-1, x.shape[-1]) if kind == "1x1" else j(x)
    jy, js = jfwd(jx, ja, jb, j(w), j(c), affine=affine, relu=relu)
    jdx, jdw, jdab = jbwd(jx, ja, jb, j(w), j(c), jy, j(dy), j(ds),
                          affine=affine, relu=relu)
    assert jy.dtype == jnp.float16 and jdx.dtype == jnp.float16
    y, st = pfwd(x, a, b, w, c, affine, relu)
    yj = torch.from_numpy(_f32(jy).copy()).half().reshape(y.shape)
    dx, dw, dab = pbwd(x, a, b, w, c, yj, dy, ds, affine, relu)
    assert y.dtype == F16 and dx.dtype == F16
    want = [_f32(jy), _f32(js), _f32(jdx), _f32(jdw),
            _f32(jdab) if affine else None]
    got = [_f32(t) for t in (y, st, dx, dw)] + [
        _f32(dab) if affine else None]
    want = [None if t is None else t.reshape(g.shape)
            for t, g in zip(want, got)]
    return want, got, _conv16_slack(kind, x, a, b, w, c, yj, dy, ds, affine,
                                    relu)


def _rel_norm(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("affine,relu", [(False, False), (True, True)])
@pytest.mark.parametrize("kind", list(CONV16))
def test_conv_fp16_matches_jax_interpret_kernels(jax_mode, kind, affine,
                                                 relu):
    """y and dx within 1 fp16 ulp plus :func:`_conv16_slack` (one fp16
    step of each z and dy_eff carried through the product), with at most
    0.1% of the elements past 1 ulp: both form z and dy_eff in fp32, round
    them to fp16, sum the products in fp32 in other orders and round once.
    Stats, dW, da and db (fp32 sums) within 1e-5 norm-wise."""
    jax_mode("interpret")
    want, got, (y_slack, dx_slack) = _conv16_run(kind, affine, relu,
                                                 seed=17)
    _check_fp16("y", want[0], got[0], y_slack, max_past_ulp=1e-3)
    _check_fp16("dx", want[2], got[2], dx_slack, max_past_ulp=1e-3)
    for name, i in (("stats", 1), ("dw", 3), ("dab", 4)):
        if want[i] is None:
            continue
        assert _rel_norm(got[i], want[i]) <= 1e-5, (name, _rel_norm(
            got[i], want[i]))


@pytest.mark.parametrize("kind", ["1x1"])
def test_conv_fp16_dy_eff_overflow_masks_match_jax(jax_mode, kind):
    """dy at 2^13 (finite in fp16) and the stats cotangent's ds1 at 2^14:
    dy_eff = dy + ds0 + 2 (y - c) ds1, formed in fp32, passes 65504 and
    rounds to inf. dx, dW, da and db are non-finite at the same elements
    on both sides."""
    jax_mode("interpret")
    want, got, _ = _conv16_run(kind, True, True, seed=18,
                               dy_scale=2.0 ** 13, ds1_scale=2.0 ** 14)
    assert not np.isfinite(want[2]).all()
    for name, w, g in zip(("dx", "dw", "dab"), want[2:], got[2:]):
        assert np.array_equal(np.isfinite(w), np.isfinite(g)), name


@pytest.mark.parametrize("op,x_shape,w_shape", [
    (conv1x1_bn_act, (2, 5, 5, 24), (24, 40)),
    (conv3x3_bn_act, (2, 5, 5, 24), (3, 3, 24, 40))])
def test_conv_autograd_keeps_fp16(op, x_shape, w_shape):
    rng = np.random.RandomState(19)
    x = torch.from_numpy(rng.randn(*x_shape).astype(np.float32)).half()
    w = torch.from_numpy(0.1 * rng.randn(*w_shape).astype(np.float32)).half()
    a = torch.rand(24) + 0.5
    b = torch.randn(24)
    for t in (x, w, a, b):
        t.requires_grad_()
    y, s = op(x, w, a, b, relu=True)
    assert y.dtype == F16 and s.dtype == torch.float32
    (y.float().square().sum() + s.sum()).backward()
    assert x.grad.dtype == F16 and w.grad.dtype == F16
    assert a.grad.dtype == torch.float32
    assert all(torch.isfinite(t.grad).all() for t in (x, w, a, b))
