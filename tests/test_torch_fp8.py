"""The port's ``amp.fp8`` against the JAX package's, on the CPU.

Held here:

- ``quantize``, ``dequantize`` and ``qdq`` are bitwise JAX's, in e4m3 and
  e5m2, over every bf16 and every fp16 bit pattern and over 10^5 seeded
  f32 values with the specials added (±0, ±inf, NaN, ±448, ±57344 and
  the values just past them, f32 and fp8 subnormals), at scales 1, 2^-7
  and 2^9. A NaN is compared as NaN, not by its bits;
- a seeded 24-step ``update_fp8_state`` walk with inf, NaN and 0 amaxes,
  both ``amax_compute_algo``s, margins 0 and 2 and an e5m2 tensor: the
  histories and scales bitwise;
- ``fp8_dense`` on both paths at a ragged shape (x [2, 3, 20], w [20,
  12]), two steps so the second runs on updated scales, in f32 and bf16,
  the same cotangent fed to both packages: the new state bitwise; ``y``,
  ``dx`` and ``dw`` within one bf16 ulp in bf16 (the fp32 products are
  summed in other orders) and 1e-6 of the largest |value| in f32;
- the port's own rules: the recipe's checks, ``reduce_amaxes`` the
  identity, ``native_fp8_dot_supported`` on the CPU, a CUDA probe without
  a card raising, the native backward flattening lead dims.

``tests/test_torch_cuda_fp8.py`` holds ``torch._scaled_mm`` to its plain
version on the card.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.amp import fp8 as jfp8
from apex_tpu_torch.amp import fp8

DTYPES = {"e4m3": (fp8.E4M3, jfp8.E4M3), "e5m2": (fp8.E5M2, jfp8.E5M2)}
SCALES = (1.0, 2.0 ** -7, 2.0 ** 9)
F32_SPECIALS = [0.0, -0.0, np.inf, -np.inf, np.nan, 448.0, -448.0, 464.0,
                -480.0, 57344.0, -57344.0, 61440.0, 1e-45, -1e-45, 1e-39,
                2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -11, 2.0 ** -16,
                2.0 ** -17, 3 * 2.0 ** -18, 1.5 * 2.0 ** -16]


def _inputs(kind):
    """(torch tensor, numpy array) holding the same values."""
    if kind in ("bf16", "fp16"):
        bits = np.arange(-32768, 32768, dtype=np.int16)
        if kind == "bf16":
            return (torch.from_numpy(bits.copy()).view(torch.bfloat16),
                    bits.view(ml_dtypes.bfloat16))
        return (torch.from_numpy(bits.copy()).view(torch.float16),
                bits.view(np.float16))
    rng = np.random.RandomState(0)
    vals = np.concatenate([
        rng.standard_normal(50_000) * np.exp2(rng.uniform(-20, 20, 50_000)),
        rng.uniform(-500, 500, 50_000), F32_SPECIALS]).astype(np.float32)
    return torch.from_numpy(vals.copy()), vals


def _bits(t):
    """The bits of a torch tensor, as numpy unsigned integers."""
    size = t.element_size()
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[size]
    return t.contiguous().view(view).numpy().view(f"u{size}")


def _jbits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def _same(got, want, nan_of):
    """Equal bits where ``want`` is not NaN; NaN where it is."""
    nan = np.isnan(np.asarray(nan_of, dtype=np.float32))
    got_nan = np.isnan(got.to(torch.float32).numpy())
    assert np.array_equal(got_nan, nan)
    g, w = _bits(got), _jbits(want)
    bad = np.flatnonzero((g != w) & ~nan)
    assert bad.size == 0, (bad[:8], g[bad[:8]], w[bad[:8]])


@pytest.mark.parametrize("storage", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["bf16", "fp16", "f32"])
def test_quantize_dequantize_qdq_bitwise(kind, storage):
    tdt, jdt = DTYPES[storage]
    x, xn = _inputs(kind)
    xj = jnp.asarray(xn)
    for s in SCALES:
        ts = torch.tensor(s, dtype=torch.float32)
        js = jnp.asarray(s, jnp.float32)
        q = fp8.quantize(x, ts, tdt)
        qj = jfp8.quantize(xj, js, jdt)
        assert q.dtype == tdt
        _same(q, qj, np.asarray(qj).astype(np.float32))
        for out in (torch.float32, x.dtype):
            jout = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
                    torch.float16: jnp.float16}[out]
            d = fp8.dequantize(q, ts, out)
            dj = jfp8.dequantize(qj, js, jout)
            _same(d, dj, np.asarray(dj).astype(np.float32))
        r = fp8.qdq(x, ts, tdt)
        rj = jfp8.qdq(xj, js, jdt)
        assert r.dtype == x.dtype
        _same(r, rj, np.asarray(rj).astype(np.float32))


def _amax_walk(steps=24, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(steps):
        a = np.float32(rng.uniform(0, 2) * 10.0 ** rng.randint(-3, 4))
        out.append({3: np.inf, 7: np.nan, 11: 0.0, 12: 0.0,
                    17: -np.inf}.get(i, a))
    return out


@pytest.mark.parametrize("algo", ["max", "most_recent"])
@pytest.mark.parametrize("margin", [0, 2])
def test_update_walk_bitwise(algo, margin):
    names = ["x", "w", "g"]
    tr = fp8.Fp8Recipe(margin=margin, amax_history_len=5,
                       amax_compute_algo=algo)
    jr = jfp8.Fp8Recipe(margin=margin, amax_history_len=5,
                        amax_compute_algo=algo)
    ts = fp8.init_fp8_state(names, tr, device="cpu")
    js = jfp8.init_fp8_state(names, jr)
    walks = {n: _amax_walk(seed=3 + i) for i, n in enumerate(names)}
    for step in range(24):
        amax = {n: walks[n][step] for n in names}
        ts = fp8.update_fp8_state(
            ts, {n: torch.tensor(v, dtype=torch.float32)
                 for n, v in amax.items()},
            tr, dtypes={"g": tr.bwd_dtype})
        js = jfp8.update_fp8_state(
            js, {n: jnp.asarray(v, jnp.float32) for n, v in amax.items()},
            jr, axis_names=(), dtypes={"g": jr.bwd_dtype})
        for n in names:
            for key in ("amax_history", "scale"):
                assert np.array_equal(_bits(ts[n][key]),
                                      _jbits(js[n][key])), (step, n, key)
    # the walk reached scales past 1 and kept them through inf/NaN/0
    assert float(ts["g"]["scale"]) > 1.0


def _normal(rng, shape, scale=1.0):
    return np.asarray(rng.standard_normal(shape) * scale, np.float32)


def _dense_inputs(dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = _normal(rng, (2, 3, 20), 3.0)
    w = _normal(rng, (20, 12), 0.2)
    g = _normal(rng, (2, 3, 12))
    x2 = _normal(rng, (2, 3, 20), 0.5)
    if dtype == "bf16":
        cast = (lambda a: a.astype(ml_dtypes.bfloat16))
        tdt, jdt = torch.bfloat16, jnp.bfloat16
    else:
        cast = (lambda a: a)
        tdt, jdt = torch.float32, jnp.float32
    return [cast(a) for a in (x, w, g, x2)], tdt, jdt


def _to_torch(a, tdt):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(tdt)


def _close(got, want, dtype):
    g = got.detach().to(torch.float32).numpy()
    w = np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape
    if dtype == "bf16":
        mag = np.maximum(np.abs(g), np.abs(w))
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
        assert (np.abs(g - w) <= ulp).all(), float(
            (np.abs(g - w) / ulp).max())
    else:
        big = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= 1e-6 * big


@pytest.mark.parametrize("native", [True, False], ids=["native", "qdq"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fp8_dense_two_steps_match_jax(dtype, native):
    (x, w, g, x2), tdt, jdt = _dense_inputs(dtype)
    tr, jr = fp8.Fp8Recipe(amax_history_len=4), \
        jfp8.Fp8Recipe(amax_history_len=4)
    ts = fp8.init_fp8_state(["x", "w"], tr, device="cpu")
    js = jfp8.init_fp8_state(["x", "w"], jr)
    for xin in (x, x2):
        xt = _to_torch(xin, tdt).requires_grad_(True)
        wt = _to_torch(w, tdt).requires_grad_(True)
        y, ts_new = fp8.fp8_dense(xt, wt, ts, recipe=tr, native=native)
        y.backward(_to_torch(g, tdt))

        def f(a, b, state=js):
            return jfp8.fp8_dense(a, b, state, recipe=jr, axis_names=(),
                                  native=native)

        (yj, js_new), vjp = jax.vjp(f, jnp.asarray(xin, jdt),
                                    jnp.asarray(w, jdt))
        dxj, dwj = vjp((jnp.asarray(g, jdt),
                        jax.tree.map(jnp.zeros_like, js_new)))
        assert y.dtype == tdt and xt.grad.dtype == tdt
        _close(y, yj, dtype)
        _close(xt.grad, dxj, dtype)
        _close(wt.grad, dwj, dtype)
        for n in ("x", "w"):
            for key in ("amax_history", "scale"):
                assert np.array_equal(_bits(ts_new[n][key]),
                                      _jbits(js_new[n][key]))
        ts, js = ts_new, js_new
    assert float(ts["x"]["scale"]) != 1.0


def test_recipe_checks_and_identity_reduce():
    with pytest.raises(ValueError, match="amax_history_len"):
        fp8.Fp8Recipe(amax_history_len=0)
    with pytest.raises(ValueError, match="amax_compute_algo"):
        fp8.Fp8Recipe(amax_compute_algo="mean")
    a = {"x": torch.tensor(2.0)}
    assert fp8.reduce_amaxes(a, ("data", "tensor")) is a
    assert fp8.fp8_max(fp8.E4M3) == 448.0 and fp8.fp8_max(fp8.E5M2) == 57344.0
    assert fp8.native_fp8_dot_supported("cpu")
    assert jfp8.native_fp8_dot_supported()


def test_probe_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fp8.native_fp8_dot_supported()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fp8.init_fp8_state(["x"])


def test_native_backward_flattens_lead_dims_like_two_dims():
    """dw contracts over every lead dim: a [2, 3, K] input gives the same
    grads as its [6, K] flattening."""
    (x, w, g, _), tdt, _ = _dense_inputs("f32", seed=5)
    state = fp8.init_fp8_state(["x", "w"], device="cpu")
    grads = []
    for shape in ((2, 3, 20), (6, 20)):
        xt = _to_torch(x, tdt).reshape(shape).requires_grad_(True)
        wt = _to_torch(w, tdt).requires_grad_(True)
        y, _ = fp8.fp8_dense(xt, wt, state, native=True)
        y.backward(_to_torch(g, tdt).reshape(*shape[:-1], 12))
        grads.append((xt.grad.reshape(6, 20), wt.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
