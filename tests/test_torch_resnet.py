"""The port's ResNet, its NHWC conv / batch-norm helpers and FusedSGD
training against the JAX package.

Model level: ResNet-50 at 64 px, batch 4, ``num_classes=8`` (the size
``tests/test_conv_fused.py`` picked so the deepest batch norm's 16 samples
a channel keep its variance well above eps), f32, ``zero_init_residual=
False`` (with it every bn3 scale is 0 and conv1-3 of each block get no
gradient at step 1). The JAX model's ``init`` is converted onto the port
(``load_jax_params`` with the batch-norm state); the same numpy-made batch
goes through both. Compared: the loss, every gradient leaf and the new
batch-norm state on the fused training path (the port's plain versions on
the CPU), on the unfused training path, and in eval; one fused block on
its own; then three FusedSGD steps (lr 0.1, momentum 0.9, wd 1e-4) on the
fused path.

The JAX side runs its plain compositions (``APEX_TPU_FORCE_PALLAS=off``:
``_ref_impl`` / ``_c3_ref_impl``, in f32 the kernels' math); the
interpret-mode kernels themselves are held against the port op by op in
``tests/test_torch_conv_fused.py``. Each test states its tolerance: this
model's f32 gradient at batch 4 is chaotic (a 1e-7 perturbation of the
input moves JAX's own gradient by ~2%), so the step-1 gradients are held to
a measured noise floor, a single fused block to 2e-5, and the three SGD
steps run the recipe's ``zero_init_residual=True``, where they are not
chaotic.

fp16 (``compute_dtype=float16``, the JAX package's
``examples/imagenet_amp.py`` configuration with fp16 in place of bf16 and
amp O2's dynamic loss scale): the two fused blocks in fp16 against the JAX
blocks in fp16 with the Pallas kernels in interpret mode (the rounding
points of Kernels J-M), each held to its distance from the f32 block; the
amp O2 fp16 flow on the port's ResNet-50 (FusedSGD over fp32 masters, an
injected inf skipped bitwise); and, slow, three such steps against the JAX
flow.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

import apex_tpu.ops._support as jax_support
from apex_tpu import amp as jamp
from apex_tpu.models import ResNet as JaxResNet
from apex_tpu.models import ResNetConfig as JaxResNetConfig
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.utils import batch_norm as jbn
from apex_tpu.utils.conv import conv_nhwc as jax_conv_nhwc
from apex_tpu_torch import amp
from apex_tpu_torch.convert import (
    grads_to_jax,
    load_jax_params,
    params_to_jax,
    state_to_jax,
)
from apex_tpu_torch.models import ResNet, ResNetConfig, resnet50
from apex_tpu_torch.ops import LAUNCHES, reset_launches
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.training import make_train_step
from apex_tpu_torch.utils import batch_norm as tbn
from apex_tpu_torch.utils.conv import conv_nhwc, max_pool_nhwc
from apex_tpu_torch.utils.flops import resnet50_train_flops

BATCH, SIZE, CLASSES = 4, 64, 8
LR = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)


@pytest.fixture
def jax_reference(monkeypatch):
    """The JAX package's plain compositions (``_ref_impl``,
    ``_c3_ref_impl`` and XLA's autodiff of them): in f32 they are the fused
    kernels' math, and they compile in seconds where interpret mode takes
    a minute for the whole model."""
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


def _leaves(tree, prefix=()):
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else enumerate(tree))
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v, np.float32)


def _paths_and_values(got, want):
    g, w = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, path
    return [p for p, _ in g], [a for _, a in g], [b for _, b in w]


def _assert_trees_close(got, want, rel, atol=0.0):
    """Each leaf within ``rel`` of its own largest magnitude, plus
    ``atol``."""
    paths, g, w = _paths_and_values(got, want)
    for path, a, b in zip(paths, g, w):
        bound = rel * float(np.abs(b).max()) + atol
        assert float(np.abs(a - b).max()) <= bound, (
            path, float(np.abs(a - b).max()), bound)


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    y = rng.randint(0, CLASSES, BATCH)
    return x, y


@functools.lru_cache(maxsize=None)
def _jax_init(zero_init_residual):
    """The JAX ResNet-50's ``init`` (~10 s eager on the CPU), once per
    module for each ``zero_init_residual``: no other config field reaches
    it."""
    cfg = JaxResNetConfig(depth=50, num_classes=CLASSES,
                          zero_init_residual=zero_init_residual)
    return JaxResNet(cfg).init(jax.random.PRNGKey(0))


def _jax_model(fused, zero_init_residual=False, compute_dtype=jnp.float32):
    cfg = JaxResNetConfig(depth=50, num_classes=CLASSES, fused_conv=fused,
                          zero_init_residual=zero_init_residual,
                          compute_dtype=compute_dtype)
    params, state = _jax_init(zero_init_residual)
    # fresh containers over the shared (immutable) arrays, so that no test
    # sees another's edits of the trees
    fresh = lambda t: jax.tree.map(lambda a: a, t)  # noqa: E731
    return JaxResNet(cfg), fresh(params), fresh(state)


def _jax_value_and_grad(model, y):
    """``f(params, state, x) -> ((loss, new_state), grads)``, jitted once
    for every x of the batch's shape."""
    def loss(p, s, x):
        logits, new_s = model.apply(p, s, x, train=True)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(x.shape[0]), jnp.asarray(y)]), new_s
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _port_model(fused, params, state, compute_dtype=torch.float32,
                zero_init_residual=False):
    model = ResNet(ResNetConfig(depth=50, num_classes=CLASSES,
                                fused_conv=fused,
                                zero_init_residual=zero_init_residual,
                                compute_dtype=compute_dtype), device="cpu")
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return load_jax_params(model, np_tree(params), np_tree(state))


def _port_step1(model, x, y):
    model.zero_grad(set_to_none=True)
    loss = F.cross_entropy(model(torch.tensor(x)), torch.tensor(y))
    loss.backward()
    return float(loss.detach()), grads_to_jax(model), state_to_jax(model)


def _norm(vs):
    return float(np.sqrt(sum(float(np.sum(np.square(v))) for v in vs)))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_resnet50_loss_grads_state_match_jax(jax_reference, fused):
    """Step-1 loss, every gradient leaf and the new batch-norm state.

    This model's f32 gradient is chaotic at batch 4: JAX's own gradient
    moves by up to 2% of the tree's norm (and up to ~1.5% of a leaf's)
    when the input is perturbed by 1e-7 relative, about one rounding. So
    the gradients are held to that noise floor, measured here from three
    such perturbations of the JAX input: each leaf's difference within 8x
    the largest of the three (or 1e-5 of the leaf's norm), the whole
    tree's within 3x. Measured: the fused path's leaves within 2.0x, the
    unfused path's within 4.1x (its convolutions sum in another order than
    XLA's); the trees within 0.8x and 1.9x. The loss to rtol 2e-4 and the
    state (a forward quantity) to 1e-3 of each leaf's largest magnitude."""
    jm, params, state = _jax_model(fused)
    x, y = _batch()
    f = _jax_value_and_grad(jm, y)
    (jloss, jstate), jgrads = f(params, state, jnp.asarray(x))
    floor = []
    for seed in (9, 10, 11):
        noise = np.random.RandomState(seed).randn(*x.shape)
        xp = (x * (1 + 1e-7 * noise)).astype(np.float32)
        floor.append(jax.tree.map(np.asarray, f(params, state,
                                                jnp.asarray(xp))[1]))
    reset_launches()
    loss, grads, new_state = _port_step1(_port_model(fused, params, state),
                                         x, y)
    assert sum(LAUNCHES.values()) == 0        # the CPU runs no kernel
    np.testing.assert_allclose(loss, float(jloss), rtol=2e-4)
    _assert_trees_close(new_state, jax.tree.map(np.asarray, jstate), 1e-3,
                        atol=1e-5)
    paths, got, want = _paths_and_values(grads,
                                         jax.tree.map(np.asarray, jgrads))
    floors = [_paths_and_values(t, jax.tree.map(np.asarray, jgrads))[1]
              for t in floor]
    for i, (path, a, b) in enumerate(zip(paths, got, want)):
        leaf_floor = max(_norm([fl[i] - b]) for fl in floors)
        assert _norm([a - b]) <= max(8 * leaf_floor, 1e-5 * _norm([b])), (
            path, _norm([a - b]), leaf_floor)
    tree_floor = max(_norm([u - v for u, v in zip(fl, want)])
                     for fl in floors)
    assert _norm([a - b for a, b in zip(got, want)]) <= 3 * tree_floor


@pytest.mark.parametrize("blk_index", [(0, 1), (1, 0)],
                         ids=["layer1.1_stride1", "layer2.0_stride2_down"])
def test_fused_block_matches_jax(jax_reference, blk_index):
    """One fused bottleneck, where the gradient is well conditioned: its
    output, new batch-norm state, and the gradients of its input and
    parameters to 2e-5 of each leaf's largest magnitude (f32 sums in other
    orders)."""
    si, bi = blk_index
    jm, params, state = _jax_model(True)
    jp = params[f"layer{si + 1}"][bi]
    js = state[f"layer{si + 1}"][bi]
    cin = jp["conv1"].shape[2]
    stride = 2 if (si > 0 and bi == 0) else 1
    rng = np.random.RandomState(5)
    x = rng.randn(4, 8, 8, cin).astype(np.float32)
    r = rng.randn(4, 8 // stride, 8 // stride,
                  jp["conv3"].shape[3]).astype(np.float32)

    def f(p, xx):
        out, new_s = jm._block_apply_fused(p, js, xx, stride)
        return jnp.sum(out * r), (out, new_s)

    (_, (jout, jnew)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    model = _port_model(True, params, state)
    blk = model.stages()[si][bi]
    xt = torch.tensor(x).requires_grad_()
    out = model._block_apply_fused(blk, xt)
    (out * torch.tensor(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=2e-5,
                               atol=2e-5 * float(np.abs(jgx).max()))
    tree = grads_to_jax(model)[f"layer{si + 1}"][bi]
    _assert_trees_close(tree, jax.tree.map(np.asarray, jgp), 2e-5)
    _assert_trees_close(state_to_jax(model)[f"layer{si + 1}"][bi],
                        jax.tree.map(np.asarray, jnew), 2e-5, atol=1e-6)


def _block_run(blk_index, dtype, params, state, jax_model=None):
    """The fused bottleneck ``blk_index`` of a ResNet-50 whose weights are
    ``params``/``state``, on test_fused_block_matches_jax's input and
    cotangent with its conv weights and input in ``dtype``: with
    ``jax_model`` the JAX block (its conv weights cast as ``apply`` casts
    them), else the port's. Returns {leaf: fp32 numpy}: the output, the
    input gradient, the parameter gradients (``g``) and the new batch-norm
    state (``s``)."""
    si, bi = blk_index
    name = f"layer{si + 1}"
    jp, js = params[name][bi], state[name][bi]
    stride = 2 if (si > 0 and bi == 0) else 1
    rng = np.random.RandomState(5)
    x = rng.randn(4, 8, 8, jp["conv1"].shape[2]).astype(np.float32)
    r = rng.randn(4, 8 // stride, 8 // stride,
                  jp["conv3"].shape[3]).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.float16), np.float32)
    if jax_model is not None:
        jdt = jnp.float16 if dtype == torch.float16 else jnp.float32

        def f(p, xx):
            pc = jax.tree.map(lambda a: a.astype(jdt) if a.ndim == 4 else a,
                              p)
            out, new_s = jax_model._block_apply_fused(pc, js, xx, stride)
            return jnp.sum(out.astype(jnp.float32) * r), (out, new_s)

        (_, (out, new_s)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x, jdt))
    else:
        model = _port_model(True, params, state, compute_dtype=dtype)
        blk = model.stages()[si][bi]
        xt = torch.tensor(x).to(dtype).requires_grad_()
        out = model._block_apply_fused(blk, xt)
        assert out.dtype == dtype
        (out.float() * torch.tensor(r)).sum().backward()
        out, gx = out.detach(), xt.grad
        gp = grads_to_jax(model)[name][bi]
        new_s = state_to_jax(model)[name][bi]
    leaves = {("out",): out, ("gx",): gx}
    leaves.update({("g",) + p: v for p, v in _leaves(gp)})
    leaves.update({("s",) + p: v for p, v in _leaves(new_s)})
    return {k: (v.float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float32)) for k, v in leaves.items()}


@pytest.mark.parametrize("blk_index,mode", [
    pytest.param((0, 1), "off", id="layer1.1_stride1"),
    # J and K beside the strided conv2 (cuDNN's on the card): slow, since
    # layer1.1 already holds all four fused kernels in fp16 to JAX's
    pytest.param((1, 0), "off", id="layer2.0_stride2_down",
                 marks=pytest.mark.slow),
    # the same blocks against the JAX kernels themselves in interpret mode
    # (~3x the compile time; each kernel's fp16 plain version is held to
    # them in tests/test_torch_fp16.py)
    pytest.param((0, 1), "interpret", id="layer1.1_stride1_interpret",
                 marks=pytest.mark.slow),
    pytest.param((1, 0), "interpret", id="layer2.0_stride2_down_interpret",
                 marks=pytest.mark.slow)])
def test_fused_block_fp16_matches_jax(monkeypatch, blk_index, mode):
    """The fused bottleneck in fp16 (Kernels J-M's plain versions; layer1.1
    runs all four, layer2.0 J and K beside the strided conv2), against the
    JAX block in fp16: with ``mode`` "off" its plain compositions, as
    test_fused_block_matches_jax runs it, with "interpret" its fused convs'
    Pallas kernels in interpret mode. Both round at fp16 points that the
    batch-norm backward's cancellations amplify (each side's gradients sit
    1-4% norm-wise from the f32 block), so each leaf is held to its
    distance from the port's f32 block (itself within 2e-5 of JAX's,
    test_fused_block_matches_jax): the port's fp16 error at most twice
    JAX's fp16 error, plus 1e-6 of the leaf's norm. A block computed in
    bf16, or with a rounding point moved, lands several times further."""
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", mode)
    jax_support.pallas_mode.cache_clear()
    try:
        jm, params, state = _jax_model(True, compute_dtype=jnp.float16)
        want = _block_run(blk_index, torch.float32, params, state)
        port = _block_run(blk_index, torch.float16, params, state)
        jax16 = _block_run(blk_index, torch.float16, params, state, jm)
    finally:
        jax_support.pallas_mode.cache_clear()
    assert want.keys() == port.keys() == jax16.keys()
    for key, w in want.items():
        n = float(np.linalg.norm(w))
        e_port = float(np.linalg.norm(port[key] - w))
        e_jax = float(np.linalg.norm(jax16[key] - w))
        assert np.isfinite(port[key]).all(), key
        assert e_port <= 2.0 * e_jax + 1e-6 * n, (key, e_port / n,
                                                  e_jax / n)


def _amp_fp16_flow(model, opt, batch, steps, inject_step):
    """amp O2 in fp16 on the port's ResNet (fp32 params, fp16 compute):
    scale_loss -> backward -> an inf in the fc kernel's gradient at
    ``inject_step`` -> unscale -> step(found_inf) -> update. Returns
    (losses, scaler states, found_inf by step, each step's parameters and
    optimizer state copied after it)."""
    state = amp.initialize("O2", half_dtype=torch.float16, device="cpu")
    sc, ss = state.scaler, state.scaler_states[0]
    params = list(model.parameters())
    losses, walk, founds, after = [], [], [], []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(batch[0]), batch[1])
        amp.scale_loss(loss, ss).backward()
        if i == inject_step:
            model.fc.kernel.grad[0, 0] = float("inf")
        _, found = sc.unscale([p.grad for p in params], ss)
        opt.step(found_inf=found)
        ss = sc.update(ss, found)
        losses.append(float(loss.detach()))
        walk.append(sc.state_dict(ss))
        founds.append(bool(found))
        after.append([t.detach().clone() for t in params] + [
            v.clone() for p in params for v in opt.state[p].values()
            if isinstance(v, torch.Tensor)])
    return losses, walk, founds, after


def test_resnet50_fp16_amp_flow_skips_the_overflow_step():
    """ResNet-50 (32 px, batch 4, 8 classes) with fp16 compute over fp32
    parameters under amp O2's dynamic scale (2^16) and FusedSGD over fp32
    masters, two steps: the second, whose gradients carry an injected inf,
    changes no parameter, master or momentum (bitwise) and halves the
    scale; the first finds no inf, and its update lowers the loss. Every
    conv weight reaches the fused kernels' plain versions as fp16 (the
    step after a skip: test_resnet50_fp16_amp_steps_match_jax, slow). One
    intra-op thread: the CPU's fp16 kernels, parallel, crawl when other
    test processes hold the cores (5 s alone with one thread, 2 minutes
    with eight beside five busy workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = ResNet(ResNetConfig(depth=50, num_classes=CLASSES,
                                    fused_conv=True,
                                    compute_dtype=torch.float16),
                       device="cpu",
                       generator=torch.Generator().manual_seed(0))
        opt = FusedSGD(model.parameters(), lr=0.01, momentum=0.9,
                       weight_decay=1e-4, master_weights=True)
        rng = np.random.RandomState(6)
        batch = (torch.from_numpy(rng.randn(BATCH, 32, 32, 3).astype(
            np.float32)), torch.from_numpy(rng.randint(0, CLASSES, BATCH)))
        losses, walk, founds, after = _amp_fp16_flow(model, opt, batch, 2,
                                                     1)
    finally:
        torch.set_num_threads(threads)
    assert founds == [False, True]
    assert [w["loss_scale"] for w in walk] == [2.0 ** 16, 2.0 ** 15]
    assert all(torch.equal(a, b) for a, b in zip(after[0], after[1]))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert losses[1] < losses[0]


def test_resnet50_eval_matches_jax(jax_reference):
    """Eval normalizes with the running statistics on the unfused path and
    leaves them as they were, also with ``fused_conv``."""
    jm, params, state = _jax_model(True)
    x, _ = _batch(2)
    logits, _ = jax.jit(lambda p, s: jm.apply(p, s, jnp.asarray(x),
                                              train=False))(params, state)
    model = _port_model(True, params, state).eval()
    with torch.no_grad():
        got = model(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=1e-4,
                               atol=1e-5)
    _assert_trees_close(state_to_jax(model), jax.tree.map(np.asarray, state),
                        0.0)


def test_three_fused_sgd_steps_match_jax(jax_reference):
    """Three FusedSGD steps (lr 0.1, momentum 0.9, wd 1e-4) on the fused
    path with the recipe's ``zero_init_residual=True`` (conv1-3 get
    gradients from step 2 on, once bn3's scale has moved). Losses to rtol
    1e-4, then every parameter and batch-norm buffer to 1e-4 of its leaf's
    largest magnitude (+1e-6). With ``zero_init_residual=False`` this batch
    of 4 trains chaotically: JAX against itself with the input perturbed
    by 1e-7 differs by 6% at step 2 and 20% at step 3."""
    jm, params, state = _jax_model(True, zero_init_residual=True)
    x, y = _batch(3)
    jopt = JaxFusedSGD(**LR)
    ostate = jopt.init(params)
    f = _jax_value_and_grad(jm, y)
    jlosses = []
    p, s = params, state
    for _ in range(3):
        (loss, s), grads = f(p, s, jnp.asarray(x))
        p, ostate = jopt.step(grads, p, ostate)
        jlosses.append(float(loss))
    model = _port_model(True, params, state, zero_init_residual=True)
    step = make_train_step(
        lambda b: F.cross_entropy(model(b[0]), b[1]),
        FusedSGD(model.parameters(), **LR))
    batch = (torch.tensor(x), torch.tensor(y))
    losses = [float(step(batch)) for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    _assert_trees_close(params_to_jax(model.state_dict()),
                        _with_state(jax.tree.map(np.asarray, p),
                                    jax.tree.map(np.asarray, s)), 1e-4,
                        atol=1e-6)


def _with_state(params, state):
    """The JAX params and state merged into one tree, the layout of the
    port's ``state_dict`` (parameters and buffers side by side)."""
    if isinstance(params, dict):
        return {k: _with_state(params[k], state[k])
                if k in params and k in state
                else (params[k] if k in params else state[k])
                for k in {*params, *state}}
    if isinstance(params, list):
        return [_with_state(u, v) for u, v in zip(params, state)]
    return params


@pytest.mark.slow
def test_resnet50_bf16_fused_steps_match_jax(jax_reference):
    """bf16 compute over fp32 parameters (the amp-O2 configuration) on the
    fused path with the recipe's init: three FusedSGD steps, losses to
    rtol 2e-2 (bf16 activations, rounded at the same points; the port's
    3x3 statistics come from the fp32 sum where ``_c3_ref_impl`` reduces
    the rounded bf16 output). The rate is a tenth of the recipe's, so the
    losses stay far from 0, where a relative tolerance still means
    something on a batch of four."""
    lr = dict(LR, lr=0.01)
    jm, params, state = _jax_model(True, zero_init_residual=True,
                                   compute_dtype=jnp.bfloat16)
    x, y = _batch(4)
    jopt = JaxFusedSGD(**lr, master_weights=True)
    ostate = jopt.init(params)
    f = _jax_value_and_grad(jm, y)
    jlosses = []
    p, s = params, state
    for _ in range(3):
        (loss, s), grads = f(p, s, jnp.asarray(x))
        p, ostate = jopt.step(grads, p, ostate)
        jlosses.append(float(loss))
    model = _port_model(True, params, state, compute_dtype=torch.bfloat16,
                        zero_init_residual=True)
    step = make_train_step(
        lambda b: F.cross_entropy(model(b[0]), b[1]),
        FusedSGD(model.parameters(), **lr, master_weights=True))
    batch = (torch.tensor(x), torch.tensor(y))
    losses = [float(step(batch)) for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, rtol=2e-2)


@pytest.mark.slow
def test_resnet50_fp16_amp_steps_match_jax(jax_reference):
    """The JAX package's ``examples/imagenet_amp.py`` flow in fp16: fp16
    compute over fp32 parameters, amp O2's dynamic scale from 2^16,
    FusedSGD over fp32 masters at a tenth of the recipe's rate, the
    recipe's init, an inf injected after the backward of step 1; three
    steps on both sides (the fused path; JAX's plain compositions). The
    scaler states agree at every step, the losses to rtol 2e-2 (fp16
    activations, rounded at the same points; the port's 3x3 statistics
    come from the fp32 sum where ``_c3_ref_impl`` reduces the rounded fp16
    output), and the skipped step leaves the port's parameters, masters
    and momenta bitwise as they were."""
    lr = dict(LR, lr=0.01)
    jm, params, state = _jax_model(True, zero_init_residual=True,
                                   compute_dtype=jnp.float16)
    x, y = _batch(4)
    jst = jamp.initialize("O2", half_dtype=jnp.float16)
    jsc, jss = jst.scaler, jst.scaler_states[0]
    jopt = JaxFusedSGD(**lr, master_weights=True)
    ostate = jopt.init(params)

    @jax.jit
    def jstep(p, s, os_, ss, inject):
        def loss(q):
            logits, new_s = jm.apply(q, s, jnp.asarray(x), train=True)
            logp = jax.nn.log_softmax(logits)
            lo = -jnp.mean(logp[jnp.arange(x.shape[0]), jnp.asarray(y)])
            return jsc.scale(lo, ss), (lo, new_s)
        (_, (lo, new_s)), g = jax.value_and_grad(loss, has_aux=True)(p)
        g["fc"]["kernel"] = jnp.where(
            inject, g["fc"]["kernel"].at[0, 0].set(jnp.inf),
            g["fc"]["kernel"])
        g, found = jsc.unscale(g, ss)
        p, os_ = jopt.step(g, p, os_, found_inf=found)
        return lo, p, new_s, os_, jsc.update(ss, found)

    jlosses, jscales = [], []
    p, s = params, state
    for i in range(3):
        lo, p, s, ostate, jss = jstep(p, s, ostate, jss, i == 1)
        jlosses.append(float(lo))
        jscales.append(float(jss.loss_scale))
    model = _port_model(True, params, state, compute_dtype=torch.float16,
                        zero_init_residual=True)
    opt = FusedSGD(model.parameters(), **lr, master_weights=True)
    losses, walk, founds, after = _amp_fp16_flow(
        model, opt, (torch.tensor(x), torch.tensor(y)), 3, 1)
    assert founds == [False, True, False]
    assert [w["loss_scale"] for w in walk] == jscales
    np.testing.assert_allclose(losses, jlosses, rtol=2e-2)
    assert all(torch.equal(a, b) for a, b in zip(after[0], after[1]))


# ---------------------------------------------------------------------------
# helpers: NHWC conv and pool, batch norm, FLOPs, the default device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,k,stride", [(30, 7, 2), (8, 3, 2), (9, 3, 1),
                                           (8, 1, 2), (7, 3, 2)])
def test_conv_nhwc_same_padding_matches_jax(size, k, stride):
    """JAX's SAME pads asymmetrically for stride 2 (the stem's 7x7/2 pads
    (2, 3) on an even size): the port pads the same way."""
    rng = np.random.RandomState(size + k)
    x = rng.randn(2, size, size + 1, 3).astype(np.float32)
    w = rng.randn(k, k, 3, 5).astype(np.float32)
    want = np.asarray(jax_conv_nhwc(jnp.asarray(x), jnp.asarray(w), stride))
    got = conv_nhwc(torch.tensor(x), torch.tensor(w), stride).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [112, 7, 8])
def test_max_pool_matches_reduce_window(size):
    rng = np.random.RandomState(size)
    x = rng.randn(2, size, size, 4).astype(np.float32)
    want = np.asarray(lax.reduce_window(jnp.asarray(x), -jnp.inf, lax.max,
                                        (1, 3, 3, 1), (1, 2, 2, 1), "SAME"))
    got = max_pool_nhwc(torch.tensor(x), 3, 2).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_bn_apply_matches_jax(train, masked):
    rng = np.random.RandomState(7)
    c = 6
    x = (3.0 + rng.randn(5, 4, 3, c)).astype(np.float32)
    p = {"scale": rng.rand(c).astype(np.float32) + 0.5,
         "bias": rng.randn(c).astype(np.float32)}
    s = {"mean": rng.randn(c).astype(np.float32),
         "var": rng.rand(c).astype(np.float32) + 0.5}
    mask = np.array([1, 1, 0, 1, 0], bool) if masked else None
    kw = dict(train=train, momentum=0.1, eps=1e-5, axis_name=None)
    jy, js = jbn.bn_apply(jax.tree.map(jnp.asarray, p),
                          jax.tree.map(jnp.asarray, s), jnp.asarray(x), **kw,
                          sample_mask=None if mask is None
                          else jnp.asarray(mask))
    ty, ts = tbn.bn_apply({k: torch.tensor(v) for k, v in p.items()},
                          {k: torch.tensor(v) for k, v in s.items()},
                          torch.tensor(x), **kw,
                          sample_mask=None if mask is None
                          else torch.tensor(mask))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-5, atol=1e-6)


def test_bn_sums_and_from_sums_match_jax():
    rng = np.random.RandomState(8)
    x = (10.0 + rng.randn(3, 5, 5, 4)).astype(np.float32)
    shift = np.full(4, 9.5, np.float32)
    p, s = jbn.bn_init(4)
    jsums = jbn.bn_sums(jnp.asarray(x), jnp.asarray(shift))
    ja, jb, js = jbn.bn_from_sums(p, s, jsums, 75, shift=jnp.asarray(shift),
                                  momentum=0.1, eps=1e-5, axis_name=None)
    tp, tsb = tbn.bn_init(4)
    tsums = tbn.bn_sums(torch.tensor(x), torch.tensor(shift))
    ta, tb, ts = tbn.bn_from_sums(tp, tsb, tsums, 75,
                                  shift=torch.tensor(shift), momentum=0.1,
                                  eps=1e-5, axis_name=None)
    for got, want in ((tsums, jsums), (ta, ja), (tb, jb),
                      (ts["mean"], js["mean"]), (ts["var"], js["var"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_synchronized_batch_norm_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="data-parallel slice"):
        tbn.bn_from_sums(*tbn.bn_init(2), torch.zeros(2, 2), 4,
                         shift=torch.zeros(2), momentum=0.1, eps=1e-5,
                         axis_name="data")
    with pytest.raises(NotImplementedError, match="data-parallel slice"):
        ResNet(ResNetConfig(depth=18, axis_name="data"), device="cpu")


def test_resnet50_train_flops_counts_two_per_multiply_add():
    """6 x 4.09 G a 224 px image (two FLOPs a multiply-add, three passes);
    the JAX helper's 3 x reads torchvision's multiply-adds as FLOPs."""
    assert resnet50_train_flops(256, 224) == pytest.approx(256 * 6 * 4.09e9)
    assert resnet50_train_flops(4, 112) == pytest.approx(6 * 4.09e9)


@pytest.mark.parametrize("depth,params", [(18, 11_689_512),
                                          (50, 25_557_032)])
def test_parameter_counts_are_torchvisions(depth, params):
    """The topology is torchvision's: its ResNet-18 and -50 have these
    many parameters at 1000 classes."""
    model = ResNet(ResNetConfig(depth=depth), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == params


def test_resnet_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet50()
    model = resnet50(device="cpu", num_classes=4)
    assert model.device.type == "cpu"
