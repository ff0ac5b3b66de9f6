"""FusedAdam / FusedAdamW / FusedLAMB / FusedSGD of the port against the
JAX package.

The same numpy-made parameter tree and five numpy-made gradient sets go
through ``apex_tpu.optimizers.FusedAdam`` (``init`` / ``step`` on a dict
of arrays) and through the port's ``FusedAdam`` over ``nn.Parameter``s
updated in place: both ``adam_w_mode`` values, weight decay with and
without a mask (matrices decayed, vectors not), bias correction off,
``master_weights`` over bf16 params, and a ``found_inf`` step that must
leave parameters, moments and the step count untouched; ``grad_scale``
unscales inside the step.

FusedLAMB runs the same five steps with the clip on the global gradient
norm active and inactive, both ``adam_w_mode`` values, a decay mask,
``trust_clip``, ``always_adapt`` without decay, ``grad_averaging`` off, a
zero-initialised leaf (trust ratio 1), master weights over bf16 and a
``found_inf`` step under ``grad_scale``.

FusedSGD runs the same five steps without momentum, with momentum (the
first step sets the buffer to the update direction), dampening, nesterov,
weight decay before and after the momentum (``wd_after_momentum``) and
under a mask, master weights over bf16 and a ``found_inf`` step.

FusedNovoGrad (norm types 2 and 0, ``init_zero``, ``reg_inside_moment``,
grad averaging, decay), FusedAdagrad (L2 and ``adagrad_w_mode`` decay),
FusedMixedPrecisionLamb (bf16 params over its fp32 masters, ``use_nvlamb``)
and LARC over FusedSGD and FusedAdam (clip and scale modes, with weight
decay, whose inner groups get their decay back after the step, also when
it raises) run the same five steps against their JAX counterparts.

Tolerance: fp32 parameters rtol 1e-6 + atol 1e-7 after five steps (the
same fp32 expressions; ``b ** t`` may differ by an ulp; LAMB's norms sum
in another order); bf16 parameters under master weights exactly equal
(both round the same fp32 master).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import FusedAdagrad as JaxFusedAdagrad
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.optimizers import FusedMixedPrecisionLamb as JaxMPLamb
from apex_tpu.optimizers import FusedNovoGrad as JaxFusedNovoGrad
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.parallel import LARC as JaxLARC
from apex_tpu_torch.optimizers import (
    FusedAdagrad,
    FusedAdam,
    FusedAdamW,
    FusedLAMB,
    FusedMixedPrecisionLamb,
    FusedNovoGrad,
    FusedSGD,
)
from apex_tpu_torch.parallel import LARC

SHAPES = {"w1": (6, 5), "b1": (5,), "w2": (5, 3), "scale": (3,)}
STEPS = 5


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*shape).astype(np.float32)
            for k, shape in SHAPES.items()}


def _run(kw, param_dtype="float32", found_inf_at=None, grad_scale=None,
         lamb=False, zero_leaf=False, sgd=False):
    params = _tree(0)
    if zero_leaf:
        params["b1"] = np.zeros_like(params["b1"])
    grads = [_tree(10 + i) for i in range(STEPS)]
    jmask = kw.pop("mask", False)
    jcls, tcls = ((JaxFusedLAMB, FusedLAMB) if lamb
                  else (JaxFusedSGD, FusedSGD) if sgd
                  else (JaxFusedAdam, FusedAdam))
    jopt = jcls(**kw, weight_decay_mask=(
        (lambda p: jax.tree.map(lambda x: x.ndim > 1, p)) if jmask
        else None))
    jp = {k: jnp.asarray(v, getattr(jnp, param_dtype))
          for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v).to(
        getattr(torch, param_dtype))) for k, v in params.items()}
    topt = tcls(list(tp.values()), **kw,
                     weight_decay_mask=(lambda p: p.dim() > 1) if jmask
                     else None)
    for i, g in enumerate(grads):
        skip = found_inf_at == i
        jfound = None if found_inf_at is None else jnp.asarray(skip)
        jscale = None if grad_scale is None else jnp.float32(grad_scale)
        # grads in the params' dtype on both sides (torch requires it)
        jp, jstate = jopt.step({k: jnp.asarray(v, getattr(jnp, param_dtype))
                                for k, v in g.items()},
                               jp, jstate, found_inf=jfound,
                               grad_scale=jscale)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k]).to(p.dtype)
        topt.step(found_inf=None if found_inf_at is None
                  else torch.tensor(skip),
                  grad_scale=None if grad_scale is None
                  else torch.tensor(grad_scale))
    return jp, jstate, tp, topt


def _check(jp, tp, exact=False):
    for k, p in tp.items():
        want = np.asarray(jp[k].astype(jnp.float32))
        got = p.detach().float().numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2),
    dict(lr=1e-2, adam_w_mode=False, weight_decay=0.1),
    dict(lr=1e-2, weight_decay=0.1),
    dict(lr=1e-2, weight_decay=0.1, mask=True),
    dict(lr=1e-2, adam_w_mode=False, weight_decay=0.1, mask=True),
    dict(lr=3e-3, betas=(0.8, 0.95), eps=1e-6, bias_correction=False),
], ids=["adamw", "adam_l2", "adamw_wd", "adamw_wd_mask", "adam_l2_mask",
        "no_bias_correction"])
def test_five_steps_match_jax(kw):
    jp, _, tp, _ = _run(dict(kw))
    _check(jp, tp)


def test_master_weights_over_bf16_params():
    jp, jstate, tp, topt = _run(dict(lr=1e-2, weight_decay=0.1,
                                     master_weights=True),
                                param_dtype="bfloat16")
    for k, p in tp.items():
        assert p.dtype == torch.bfloat16
        np.testing.assert_allclose(topt.state[p]["master"].numpy(),
                                   np.asarray(jstate["master"][k]),
                                   rtol=1e-6, atol=1e-7)
    _check(jp, tp, exact=True)


def test_found_inf_skips_the_step_on_the_device():
    jp, jstate, tp, topt = _run(dict(lr=1e-2), found_inf_at=2,
                                grad_scale=4.0)
    _check(jp, tp)
    for k, p in tp.items():
        st = topt.state[p]
        assert int(st["step"]) == int(jstate["step"]) == STEPS - 1
        np.testing.assert_allclose(
            st["exp_avg"].numpy(),
            np.asarray(jstate["slots"]["exp_avg"][k]), rtol=1e-6, atol=1e-8)


def test_adamw_factory_and_amsgrad():
    p = torch.nn.Parameter(torch.zeros(3))
    assert FusedAdamW([p]).adam_w_mode
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam([p], amsgrad=True)


@pytest.mark.parametrize("kw,zero_leaf", [
    (dict(lr=1e-2), False),
    (dict(lr=1e-2, max_grad_norm=100.0), False),
    (dict(lr=1e-2, max_grad_norm=0.0), False),
    (dict(lr=1e-2, adam_w_mode=False, weight_decay=0.1), False),
    (dict(lr=1e-2, weight_decay=0.1, mask=True), False),
    (dict(lr=1e-2, adam_w_mode=False, weight_decay=0.1, mask=True), False),
    (dict(lr=5e-2, weight_decay=0.3, trust_clip=True), False),
    (dict(lr=1e-2, weight_decay=0.0, always_adapt=True), False),
    (dict(lr=1e-2, weight_decay=0.0), False),
    (dict(lr=1e-2, grad_averaging=False, bias_correction=False,
          betas=(0.8, 0.95)), False),
    (dict(lr=1e-2, weight_decay=0.05), True),
], ids=["clip_active", "clip_inactive", "no_clip", "l2", "adamw_mask",
        "l2_mask", "trust_clip", "always_adapt", "no_decay_no_adapt",
        "no_grad_averaging", "zero_leaf"])
def test_lamb_five_steps_match_jax(kw, zero_leaf):
    jp, _, tp, _ = _run(dict(kw), lamb=True, zero_leaf=zero_leaf)
    _check(jp, tp)


def test_lamb_master_weights_over_bf16_params():
    jp, jstate, tp, topt = _run(dict(lr=1e-2, weight_decay=0.1,
                                     master_weights=True),
                                param_dtype="bfloat16", lamb=True)
    for k, p in tp.items():
        assert p.dtype == torch.bfloat16
        np.testing.assert_allclose(topt.state[p]["master"].numpy(),
                                   np.asarray(jstate["master"][k]),
                                   rtol=1e-6, atol=1e-7)
    _check(jp, tp, exact=True)


def test_lamb_found_inf_skips_the_step_on_the_device():
    jp, jstate, tp, topt = _run(dict(lr=1e-2, weight_decay=0.1),
                                found_inf_at=1, grad_scale=8.0, lamb=True)
    _check(jp, tp)
    for k, p in tp.items():
        assert int(topt.state[p]["step"]) == int(jstate["step"]) == STEPS - 1


def test_lamb_clip_is_global_and_stays_on_the_device():
    """The clip factor is the global norm over every gradient (one tensor's
    rescaling shrinks another's update) and is a tensor, not a host
    number."""
    p1 = torch.nn.Parameter(torch.ones(4))
    p2 = torch.nn.Parameter(torch.ones(4))
    opt = FusedLAMB([p1, p2], lr=0.1, weight_decay=0.0, max_grad_norm=1.0)
    p1.grad = torch.full((4,), 3.0)
    p2.grad = torch.full((4,), 4.0)
    opt.step()
    assert isinstance(opt._clip, torch.Tensor)
    assert float(opt._clip) == pytest.approx(10.0)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLAMB([p1], amsgrad=True)


@pytest.mark.parametrize("kw", [
    dict(lr=0.1),
    dict(lr=0.1, momentum=0.9),
    dict(lr=0.1, momentum=0.9, dampening=0.2),
    dict(lr=0.1, momentum=0.9, nesterov=True),
    dict(lr=0.1, momentum=0.9, weight_decay=1e-2),
    dict(lr=0.1, momentum=0.9, weight_decay=1e-2, wd_after_momentum=True),
    dict(lr=0.1, momentum=0.9, weight_decay=1e-2, mask=True),
    dict(lr=0.05, weight_decay=1e-2),
], ids=["plain", "momentum", "dampening", "nesterov", "wd", "wd_after",
        "wd_mask", "wd_no_momentum"])
def test_sgd_five_steps_match_jax(kw):
    jp, jstate, tp, topt = _run(dict(kw), sgd=True)
    _check(jp, tp)
    if kw.get("momentum"):
        for k, p in tp.items():
            np.testing.assert_allclose(
                topt.state[p]["momentum_buffer"].numpy(),
                np.asarray(jstate["slots"]["momentum_buffer"][k]),
                rtol=1e-6, atol=1e-7)


def test_sgd_first_step_sets_the_buffer_to_the_direction():
    """Step 1: buf = d_p = g + wd p (not momentum * 0 + (1 - dampening)
    d_p), decided on the device."""
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    opt = FusedSGD([p], lr=0.5, momentum=0.9, dampening=0.5,
                   weight_decay=0.1)
    p.grad = torch.tensor([0.3, 0.4])
    opt.step()
    torch.testing.assert_close(opt.state[p]["momentum_buffer"],
                               torch.tensor([0.4, 0.2]))
    torch.testing.assert_close(p.detach(), torch.tensor([0.8, -2.1]))


def test_sgd_master_weights_over_bf16_params():
    jp, jstate, tp, topt = _run(dict(lr=0.1, momentum=0.9,
                                     weight_decay=1e-4, master_weights=True),
                                param_dtype="bfloat16", sgd=True)
    for k, p in tp.items():
        assert p.dtype == torch.bfloat16
        np.testing.assert_allclose(topt.state[p]["master"].numpy(),
                                   np.asarray(jstate["master"][k]),
                                   rtol=1e-6, atol=1e-7)
    _check(jp, tp, exact=True)


def test_sgd_found_inf_skips_the_step_on_the_device():
    jp, jstate, tp, topt = _run(dict(lr=0.1, momentum=0.9), found_inf_at=0,
                                grad_scale=2.0, sgd=True)
    _check(jp, tp)
    for k, p in tp.items():
        assert int(topt.state[p]["step"]) == int(jstate["step"]) == STEPS - 1
        np.testing.assert_allclose(
            topt.state[p]["momentum_buffer"].numpy(),
            np.asarray(jstate["slots"]["momentum_buffer"][k]), rtol=1e-6,
            atol=1e-7)


def test_sgd_nesterov_needs_momentum_and_no_dampening():
    p = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError, match="Nesterov"):
        FusedSGD([p], lr=0.1, nesterov=True)
    with pytest.raises(ValueError, match="Nesterov"):
        FusedSGD([p], lr=0.1, momentum=0.9, dampening=0.1, nesterov=True)


def _run_pair(jopt, make_topt, param_dtype="float32"):
    """Five steps of ``jopt`` (JAX) and ``make_topt(params)`` (the port)
    from the same numpy parameters and gradients."""
    params = _tree(0)
    grads = [_tree(10 + i) for i in range(STEPS)]
    jp = {k: jnp.asarray(v, getattr(jnp, param_dtype))
          for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v).to(
        getattr(torch, param_dtype))) for k, v in params.items()}
    topt = make_topt(list(tp.values()))
    for g in grads:
        jp, jstate = jopt.step({k: jnp.asarray(v, getattr(jnp, param_dtype))
                                for k, v in g.items()}, jp, jstate)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k]).to(p.dtype)
        topt.step()
    return jp, jstate, tp, topt


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2),
    dict(lr=1e-2, norm_type=0),
    dict(lr=1e-2, init_zero=True),
    dict(lr=1e-2, weight_decay=0.1),
    dict(lr=1e-2, weight_decay=0.1, reg_inside_moment=True),
    dict(lr=1e-2, grad_averaging=True, bias_correction=False,
         betas=(0.9, 0.99)),
    dict(lr=1e-2, norm_type=0, init_zero=True, weight_decay=0.05,
         reg_inside_moment=True),
], ids=["l2", "inf_norm", "init_zero", "wd", "reg_inside_moment",
        "grad_averaging", "inf_init_zero_reg"])
def test_novograd_five_steps_match_jax(kw):
    jp, jstate, tp, topt = _run_pair(JaxFusedNovoGrad(**kw),
                                     lambda ps: FusedNovoGrad(ps, **kw))
    _check(jp, tp)
    for k, p in tp.items():
        np.testing.assert_allclose(
            topt.state[p]["exp_avg_sq"].numpy(),
            np.asarray(jstate["slots"]["exp_avg_sq"][k]), rtol=1e-6)
    with pytest.raises(RuntimeError, match="norm"):
        FusedNovoGrad(list(tp.values()), norm_type=1)


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2),
    dict(lr=1e-2, weight_decay=0.1),
    dict(lr=1e-2, weight_decay=0.1, adagrad_w_mode=True),
    dict(lr=5e-2, eps=1e-6),
], ids=["plain", "l2", "w_mode", "eps"])
def test_adagrad_five_steps_match_jax(kw):
    jp, jstate, tp, topt = _run_pair(JaxFusedAdagrad(**kw),
                                     lambda ps: FusedAdagrad(ps, **kw))
    _check(jp, tp)
    for k, p in tp.items():
        np.testing.assert_allclose(topt.state[p]["sum"].numpy(),
                                   np.asarray(jstate["slots"]["sum"][k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("nvlamb", [False, True])
def test_mixed_precision_lamb_over_bf16_matches_jax(nvlamb):
    kw = dict(lr=1e-2, weight_decay=0.0 if nvlamb else 0.01,
              use_nvlamb=nvlamb)
    jp, jstate, tp, topt = _run_pair(
        JaxMPLamb(**kw), lambda ps: FusedMixedPrecisionLamb(ps, **kw),
        param_dtype="bfloat16")
    assert topt.master_weights
    for k, p in tp.items():
        assert p.dtype == torch.bfloat16
        np.testing.assert_allclose(topt.state[p]["master"].numpy(),
                                   np.asarray(jstate["master"][k]),
                                   rtol=1e-6, atol=1e-7)
    _check(jp, tp, exact=True)


@pytest.mark.parametrize("inner,clip", [
    ("sgd", True), ("sgd", False), ("adam", True), ("adam", False)])
def test_larc_five_steps_match_jax(inner, clip):
    kw = (dict(lr=0.1, momentum=0.9, weight_decay=1e-2) if inner == "sgd"
          else dict(lr=1e-2, weight_decay=0.1))
    jcls, tcls = ((JaxFusedSGD, FusedSGD) if inner == "sgd"
                  else (JaxFusedAdam, FusedAdam))
    jp, _, tp, topt = _run_pair(
        JaxLARC(jcls(**kw), trust_coefficient=0.02, clip=clip),
        lambda ps: LARC(tcls(ps, **kw), trust_coefficient=0.02, clip=clip))
    _check(jp, tp)
    assert topt.param_groups[0]["weight_decay"] == kw["weight_decay"]


def test_larc_restores_weight_decay_when_the_step_raises():
    p = torch.nn.Parameter(torch.ones(3))
    larc = LARC(FusedSGD([p], lr=0.1, weight_decay=0.5))
    p.grad = torch.ones(3)

    def boom(*a, **k):
        raise RuntimeError("inner step failed")

    larc.inner.step = boom
    with pytest.raises(RuntimeError, match="inner step failed"):
        larc.step()
    assert larc.param_groups[0]["weight_decay"] == 0.5
