"""The port's multi-tensor layer against the JAX package, on the CPU.

- ``flatten_by_dtype`` / ``unflatten_by_dtype`` over mixed dtypes give the
  JAX package's buffers, metas and round trip; ``multi_tensor_applier``
  with scale and axpby ops gives its results.
- The plain version of each multi-tensor kernel (the CPU branch of its
  wrapper) against the JAX function it stands for, in f32 and in bf16:
  ``multi_tensor_scale`` against ``LossScaler.unscale`` (bitwise, found_inf
  equal), ``multi_tensor_l2norm`` against ``global_norm`` (rtol 1e-6:
  summation order), and three steps of ``multi_tensor_adam``,
  ``multi_tensor_lamb`` and ``multi_tensor_sgd`` against
  ``FusedAdam``/``FusedLAMB``/``FusedSGD.step`` (fp32 parameters rtol 1e-6
  + atol 1e-7 as ``test_torch_optimizers.py``; bf16 parameters over fp32
  masters exactly equal), with a ``found_inf`` step that changes nothing.
- The list wrappers' plain versions equal the optimizers' own CPU steps
  bitwise (one math), and the kernels' operation order (emulated in
  numpy fp32, one IEEE rounding an operation, as the round-to-nearest
  intrinsics of ``csrc/multi_tensor.cu`` do) equals the plain version
  bitwise for Adam and SGD.
- The launch records (``plan``, ``TensorTable``): capacity splits, a
  tensor over more chunks than a record holds, more tensors than a record
  holds, empty tensors, and a numpy walk of the kernels' block spans that
  covers every element of every tensor exactly once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from apex_tpu.multi_tensor_apply import flatten_by_dtype as jax_flatten
from apex_tpu.multi_tensor_apply import multi_tensor_applier as jax_applier
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.utils.tree import global_norm as jax_global_norm
from apex_tpu_torch.multi_tensor_apply import (
    flatten_by_dtype,
    multi_tensor_applier,
    unflatten_by_dtype,
)
from apex_tpu_torch.ops import LAUNCHES
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB, FusedSGD
from apex_tpu_torch.utils.tree import global_norm, tree_flatten

SHAPES = {"b1": (5,), "scale": (3,), "w1": (6, 5), "w2": (5, 3)}
STEPS = 3
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tree(seed, shapes=SHAPES):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


# -- flat buckets ----------------------------------------------------------

def test_flatten_by_dtype_matches_jax_and_round_trips():
    rng = np.random.RandomState(0)
    a = rng.randn(3, 5).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    d = rng.randn(2, 3).astype(np.float32)
    e = rng.randn(1500).astype(np.float32)
    jtree = {"a": jnp.asarray(a), "b": jnp.asarray(b, jnp.bfloat16),
             "c": {"d": jnp.asarray(d), "e": jnp.asarray(e)}}
    ttree = {"c": {"e": torch.from_numpy(e), "d": torch.from_numpy(d)},
             "b": torch.from_numpy(b).to(torch.bfloat16),
             "a": torch.from_numpy(a)}
    jbuf, jmeta, _ = jax_flatten(jtree)
    tbuf, tmeta, aux = flatten_by_dtype(ttree)
    assert set(tbuf) == set(jbuf) == {"float32", "bfloat16"}
    for k in jbuf:
        assert tbuf[k].shape[0] % 1024 == 0
        np.testing.assert_array_equal(_np(tbuf[k]), _np(jbuf[k]))
        assert tmeta[k].shapes == jmeta[k].shapes
        assert tmeta[k].sizes == jmeta[k].sizes
        assert tmeta[k].padded_size == jmeta[k].padded_size
        assert str(tmeta[k].dtype).replace("torch.", "") == k
        np.testing.assert_array_equal(tmeta[k].offsets, jmeta[k].offsets)
    back = unflatten_by_dtype(tbuf, tmeta, aux)
    for x, y in zip(tree_flatten(ttree)[0], tree_flatten(back)[0]):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_multi_tensor_applier_scale_and_axpby_match_jax():
    rng = np.random.RandomState(1)
    xs = [rng.randn(4, 4).astype(np.float32), rng.randn(10).astype(
        np.float32), rng.randn(3, 3, 3).astype(np.float32)]
    ys = [rng.randn(*x.shape).astype(np.float32) for x in xs]
    (jout,) = jax_applier(lambda f, s: f * s,
                          [[jnp.asarray(x) for x in xs]], 0.5)
    (tout,) = multi_tensor_applier(lambda f, s: f * s,
                                   [[torch.from_numpy(x) for x in xs]], 0.5)
    for j, t in zip(jout, tout):
        assert tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    (jout,) = jax_applier(lambda fx, fy, a, b: a * fx + b * fy,
                          [[jnp.asarray(x) for x in xs],
                           [jnp.asarray(y) for y in ys]], 2.0, 0.5)
    (tout,) = multi_tensor_applier(lambda fx, fy, a, b: a * fx + b * fy,
                                   [[torch.from_numpy(x) for x in xs],
                                    [torch.from_numpy(y) for y in ys]],
                                   2.0, 0.5)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


# -- the plain versions against JAX ---------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_scale_plain_matches_unscale(dtype):
    jdt, tdt = DTYPES[dtype]
    tree = _tree(2)
    tree["w1"][1, 2] = np.inf
    tree["b1"][0] = np.nan
    tree["w2"] *= 3e4
    sc = JaxLossScaler("dynamic", init_scale=2.0 ** 10)
    jg, jfound = sc.unscale({k: jnp.asarray(v, jdt) for k, v in tree.items()},
                            sc.init())
    grads = [torch.from_numpy(tree[k]).to(tdt) for k in sorted(tree)]
    before = dict(LAUNCHES)
    found = mt.multi_tensor_scale(grads, torch.tensor(2.0 ** 10))
    assert LAUNCHES == before
    assert found.dtype == torch.bool and bool(found) == bool(jfound)
    for k, g in zip(sorted(tree), grads):
        assert g.dtype == tdt
        np.testing.assert_array_equal(_np(g), _np(jg[k]))
    clean = [torch.ones(3, dtype=tdt)]
    assert not bool(mt.multi_tensor_scale(clean, torch.tensor(4.0)))
    np.testing.assert_array_equal(clean[0].float().numpy(), 0.25)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_l2norm_plain_matches_global_norm(dtype):
    jdt, tdt = DTYPES[dtype]
    tree = _tree(3)
    want = jax_global_norm({k: jnp.asarray(v, jdt) for k, v in tree.items()})
    tensors = [torch.from_numpy(tree[k]).to(tdt) for k in sorted(tree)]
    total, per = mt.multi_tensor_l2norm(tensors, per_tensor=True)
    np.testing.assert_allclose(float(total), float(want), rtol=1e-6)
    for k, n in zip(sorted(tree), per):
        leaf = jnp.asarray(tree[k], jdt).astype(jnp.float32)
        np.testing.assert_allclose(float(n), float(jnp.sqrt(jnp.sum(
            leaf * leaf))), rtol=1e-6)
    assert float(global_norm({k: t for k, t in zip(sorted(tree), tensors)})
                 ) == float(total)
    scaled, _ = mt.multi_tensor_l2norm([t * 4 for t in tensors],
                                       grad_scale=torch.tensor(4.0))
    np.testing.assert_allclose(float(scaled), float(total), rtol=1e-6)


def _jax_run(jopt, dtype, grads, found_at):
    jdt = DTYPES[dtype][0]
    jp = {k: jnp.asarray(v, jdt) for k, v in _tree(0).items()}
    st = jopt.init(jp)
    for i, g in enumerate(grads):
        jp, st = jopt.step({k: jnp.asarray(v, jdt) for k, v in g.items()},
                           jp, st, found_inf=jnp.asarray(i == found_at))
    return jp, st


def _torch_lists(dtype, master):
    tdt = DTYPES[dtype][1]
    params = [torch.from_numpy(_tree(0)[k]).to(tdt) for k in sorted(SHAPES)]
    zeros = [torch.zeros(p.shape) for p in params]
    return (params, [z.clone() for z in zeros], [z.clone() for z in zeros],
            [torch.zeros((), dtype=torch.int32) for _ in params],
            [p.float().clone() for p in params] if master else None)


def _check_params(jp, params, exact):
    for k, p in zip(sorted(SHAPES), params):
        want = _np(jp[k])
        if exact:
            np.testing.assert_array_equal(_np(p), want)
        else:
            np.testing.assert_allclose(_np(p), want, rtol=1e-6, atol=1e-7)


OPT_CASES = {
    "adam": dict(jax=lambda m: JaxFusedAdam(lr=1e-2, weight_decay=0.1,
                                            master_weights=m)),
    "lamb": dict(jax=lambda m: JaxFusedLAMB(lr=1e-2, weight_decay=0.1,
                                            master_weights=m)),
    "sgd": dict(jax=lambda m: JaxFusedSGD(lr=0.1, momentum=0.9,
                                          weight_decay=1e-2,
                                          master_weights=m)),
}


def _torch_step(name, dtype, grads, found_at, master):
    tdt = DTYPES[dtype][1]
    params, m, v, steps, masters = _torch_lists(dtype, master)
    updates = [torch.empty(p.shape) for p in params]
    for i, g in enumerate(grads):
        gl = [torch.from_numpy(g[k]).to(tdt) for k in sorted(SHAPES)]
        found = torch.tensor(i == found_at)
        if name == "adam":
            mt.multi_tensor_adam(gl, params, m, v, steps, masters, lr=1e-2,
                                 weight_decay=0.1, betas=(0.9, 0.999),
                                 eps=1e-8, adam_w_mode=True,
                                 bias_correction=True, found_inf=found)
        elif name == "lamb":
            gnorm, _ = mt.multi_tensor_l2norm(gl)
            mt.multi_tensor_lamb(gl, params, m, v, updates, steps, masters,
                                 lr=1e-2, weight_decay=0.1,
                                 betas=(0.9, 0.999), eps=1e-6,
                                 adam_w_mode=True, bias_correction=True,
                                 grad_averaging=True, gnorm=gnorm,
                                 max_grad_norm=1.0, trust_clip=False,
                                 always_adapt=False, found_inf=found)
        else:
            mt.multi_tensor_sgd(gl, params, m, steps, masters, lr=0.1,
                                weight_decay=1e-2, momentum=0.9,
                                dampening=0.0, nesterov=False,
                                wd_after_momentum=False, found_inf=found)
    return params, steps, masters


@pytest.mark.parametrize("name", list(OPT_CASES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_optimizer_kernels_plain_versions_match_jax(name, dtype):
    """Three steps (the second with found_inf) of the list wrappers' plain
    versions against the JAX optimizer: bf16 runs with fp32 masters."""
    master = dtype == "bfloat16"
    grads = [_tree(10 + i) for i in range(STEPS)]
    jp, jst = _jax_run(OPT_CASES[name]["jax"](master), dtype, grads, 1)
    before = dict(LAUNCHES)
    params, steps, masters = _torch_step(name, dtype, grads, 1, master)
    assert LAUNCHES == before
    assert [int(s) for s in steps] == [STEPS - 1] * len(steps)
    assert int(jst["step"]) == STEPS - 1
    _check_params(jp, params, exact=master)
    if master:
        for k, mm in zip(sorted(SHAPES), masters):
            np.testing.assert_allclose(mm.numpy(), _np(jst["master"][k]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", list(OPT_CASES))
def test_list_plain_versions_equal_the_optimizer_steps(name):
    """One math: the list wrappers' plain versions give the optimizers'
    CPU steps bitwise (fp32 params, decay, a grad_scale)."""
    grads = [_tree(20 + i) for i in range(STEPS)]
    params = [torch.nn.Parameter(torch.from_numpy(_tree(0)[k]))
              for k in sorted(SHAPES)]
    kw = dict(lr=1e-2, weight_decay=0.1)
    opt = {"adam": lambda: FusedAdam(params, **kw),
           "lamb": lambda: FusedLAMB(params, **kw),
           "sgd": lambda: FusedSGD(params, momentum=0.9, **kw)}[name]()
    lists = _torch_lists("float32", False)
    updates = [torch.empty(p.shape) for p in params]
    for g in grads:
        gl = [torch.from_numpy(g[k]) * 8 for k in sorted(SHAPES)]
        scale = torch.tensor(8.0)
        for p, x in zip(params, gl):
            p.grad = x.clone()
        opt.step(grad_scale=scale)
        p_, m, v, steps, _ = lists
        common = dict(lr=1e-2, weight_decay=0.1, grad_scale=scale)
        if name == "adam":
            mt.multi_tensor_adam(gl, p_, m, v, steps, betas=(0.9, 0.999),
                                 eps=1e-8, adam_w_mode=True,
                                 bias_correction=True, **common)
        elif name == "lamb":
            gnorm, _ = mt.multi_tensor_l2norm(gl, grad_scale=scale)
            mt.multi_tensor_lamb(gl, p_, m, v, updates, steps,
                                 betas=(0.9, 0.999), eps=1e-6,
                                 adam_w_mode=True, bias_correction=True,
                                 grad_averaging=True, gnorm=gnorm,
                                 max_grad_norm=1.0, trust_clip=False,
                                 always_adapt=False, **common)
        else:
            mt.multi_tensor_sgd(gl, p_, m, steps, momentum=0.9,
                                dampening=0.0, nesterov=False,
                                wd_after_momentum=False, **common)
    for p, q in zip(params, lists[0]):
        assert torch.equal(p.detach(), q)


def _f32(x):
    return np.float32(x)


def test_kernel_operation_order_equals_the_plain_version():
    """csrc/multi_tensor.cu's Adam and SGD element math, one fp32 rounding
    an operation in its order (numpy fp32), against the plain version:
    bitwise. The bias corrections and square roots come from torch, as
    the kernel's powf and __fsqrt_rn stand for the card's torch pow and
    sqrt (torch's CPU sqrt is not always correctly rounded; the card's
    is)."""
    rng = np.random.RandomState(7)
    g = rng.randn(4096).astype(np.float32)
    p = rng.randn(4096).astype(np.float32)
    m = (0.1 * rng.randn(4096)).astype(np.float32)
    v = np.abs(0.01 * rng.randn(4096)).astype(np.float32)
    scale = torch.tensor(64.0)
    t = torch.tensor(3.0)
    b1, b2, eps, wd, lr = 0.9, 0.999, 1e-8, 0.1, 1e-2
    for adam_w in (True, False):
        want_p, want_m, want_v = mt.adam_update(
            mt.unscaled_fp32(torch.from_numpy(g * 64), scale),
            torch.from_numpy(p), torch.from_numpy(m), torch.from_numpy(v), t,
            lr, wd, (b1, b2), eps, adam_w, True)
        bc1 = _f32(float(1.0 - b1 ** t))
        bc2 = _f32(float(1.0 - b2 ** t))
        inv = _f32(1.0) / _f32(64.0)
        gv = (g * 64).astype(np.float32) * inv
        if not adam_w:
            gv = gv + _f32(wd) * p
        mv = _f32(b1) * m + _f32(1.0 - b1) * gv
        vv = _f32(b2) * v + (_f32(1.0 - b2) * gv) * gv
        root = torch.sqrt(torch.from_numpy(vv / bc2)).numpy()
        u = (mv / bc1) / (root + _f32(eps))
        if adam_w:
            u = u + _f32(wd) * p
        np_ = p - _f32(lr) * u
        for got, want in ((np_, want_p), (mv, want_m), (vv, want_v)):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want.numpy())
    for nesterov, after in ((False, False), (True, False), (False, True)):
        buf = (0.1 * rng.randn(4096)).astype(np.float32)
        want_p, want_b = mt.sgd_update(
            torch.from_numpy(g), torch.from_numpy(p), torch.from_numpy(buf),
            t, lr, wd, 0.9, 0.0, nesterov, after)
        d = g if after else g + _f32(wd) * p
        b = _f32(0.9) * buf + _f32(1.0) * d
        d = d + _f32(0.9) * b if nesterov else b
        if after:
            d = d + _f32(wd) * p
        np.testing.assert_array_equal(p - _f32(lr) * d, want_p.numpy())
        np.testing.assert_array_equal(b, want_b.numpy())


def test_mixed_devices_raise():
    with pytest.raises(ValueError, match="device"):
        mt.multi_tensor_scale([torch.ones(2), torch.ones(2, device="meta")],
                              torch.tensor(1.0))


# -- launch records ---------------------------------------------------------

def _covered(records):
    seen = []
    for t0, nt, chunks in records:
        assert 1 <= nt <= mt.MAX_TENSORS
        assert 1 <= len(chunks) <= mt.MAX_CHUNKS
        seen += [(t0 + j, c) for j, c in chunks]
    return seen


@pytest.mark.parametrize("sizes", [
    [1, mt.CHUNK + 1, 3],
    [mt.CHUNK] * (mt.MAX_TENSORS + 33),                   # > a record's tensors
    [5, mt.CHUNK * (mt.MAX_CHUNKS + 7) + 11, 2],          # > a record's chunks
    [0, 7, 0, 0, mt.CHUNK * 2, 0],                        # empty tensors
    [3] * (2 * mt.MAX_TENSORS) + [mt.CHUNK * mt.MAX_CHUNKS],
], ids=["corners", "many_tensors", "huge_tensor", "empty", "both"])
def test_plan_covers_every_chunk_once_within_capacity(sizes):
    records = mt.plan(sizes)
    want = [(t, c) for t, n in enumerate(sizes)
            for c in range(-(-n // mt.CHUNK))]
    assert _covered(records) == want
    # tensors of a record are consecutive from its first one, so per-tensor
    # outputs index by first tensor + local index
    for t0, nt, chunks in records:
        assert {j for j, _ in chunks} <= set(range(nt))
    expect = {"multi_tensor_adam": len(records) + 1}
    assert mt.optimizer_launches(sizes, "multi_tensor_adam") == expect


def _gpt2_sizes(layers=12, h=768, vocab=50304, positions=1024):
    """GPT-2 124M's parameter sizes: the embeddings, per layer two norms,
    QKV, the projection and two MLP matrices with their biases, the final
    norm."""
    layer = [h, h, 3 * h * h, 3 * h, h * h, h, h, h, 4 * h * h, 4 * h,
             4 * h * h, h]
    return [vocab * h, positions * h] + layer * layers + [h, h]


def test_gpt2_and_resnet50_lists_split_as_described():
    """GPT-2 124M's 148 tensors (wte 38.6M elements) and ResNet-50's 161
    both need more than one record: wte alone spans records."""
    from apex_tpu_torch.models import ResNet, ResNetConfig
    sizes = _gpt2_sizes()
    assert len(sizes) == 148 and sum(sizes) == 124475904
    records = mt.plan(sizes)
    holding = [r for r in records if r[0] <= 0 < r[0] + r[1]]
    assert len(holding) > 1 and len(records) >= 4
    rn50 = ResNet(ResNetConfig(depth=50, num_classes=8), device="cpu")
    sizes = [p.numel() for p in rn50.parameters()]
    assert len(sizes) == 161 > mt.MAX_TENSORS
    assert len(mt.plan(sizes)) >= 2


def test_table_layout_decodes_to_the_lists():
    """The words a kernel reads: addresses, codes, sizes, step counters,
    the chunk map and each tensor's first chunk; a walk of every block's
    span over each record covers every element once."""
    sizes = [3, mt.CHUNK + 5, 0, 2 * mt.CHUNK]
    g = [torch.zeros(n, dtype=torch.bfloat16) for n in sizes]
    p = [torch.zeros(n) for n in sizes]
    steps = [torch.zeros((), dtype=torch.int32) for _ in sizes]
    table = mt.TensorTable([g, p], steps)
    words = table.buffer.numpy()
    recs = words[:table.n_records * mt.WORDS].reshape(table.n_records,
                                                      mt.WORDS)
    chunk_start = words[table.n_records * mt.WORDS:][:len(sizes) + 1]
    step_words = words[table.n_records * mt.WORDS + len(sizes) + 1:]
    assert list(chunk_start) == [0, 1, 3, 3, 5]
    assert list(step_words) == [s.data_ptr() for s in steps]
    counts = [table._counts[i] for i in range(table.n_records)]
    covered = {t: np.zeros(n, int) for t, n in enumerate(sizes)}
    for r, w in enumerate(recs):
        nt, nc, t0, c0 = w[:4]
        assert nc == counts[r]
        for j in range(nt):
            t = t0 + j
            assert w[mt._ADDR + j] == g[t].data_ptr()
            assert w[mt._ADDR + mt.MAX_TENSORS + j] == p[t].data_ptr()
            assert w[mt._CODE + j] == 1 and w[mt._CODE + mt.MAX_TENSORS +
                                              j] == 0
            assert w[mt._SIZE + j] == sizes[t]
            assert w[mt._STEP + j] == steps[t].data_ptr()
        for b in range(nc):
            c = w[mt._CHUNKS + b]
            j, ci = c >> 32, c & 0xffffffff
            lo = ci * mt.CHUNK
            hi = min(lo + mt.CHUNK, w[mt._SIZE + j])
            covered[t0 + j][lo:hi] += 1
            assert chunk_start[t0 + j] + ci == c0 + b      # global chunk
    assert all((c == 1).all() for c in covered.values())
    cache = mt.TableCache()
    assert cache.get([g, p], steps) is cache.get([g, p], steps)
    p2 = list(p)
    p2[1] = torch.zeros(sizes[1])
    assert cache.get([g, p2], steps) is not cache.get([g, p], steps)
