"""The port's fp16_utils against the JAX package's, on the CPU (the
counterpart of ``tests/test_fp16_utils.py``).

- ``network_to_half`` and ``convert_network`` over trees (norm-named
  leaves stay fp32 by the default predicate, integers untouched, a
  custom or no predicate) give the JAX package's dtypes leaf for leaf, and
  over an ``nn.Module`` cast its parameters in place.
- ``prep_param_lists`` and the master <-> model copies.
- ``FP16_Optimizer``: at scale 1 over fp32 parameters it reproduces its
  inner optimizer bitwise; over bf16 parameters with a static scale it
  gives the JAX wrapper's parameters and masters for three steps (bf16
  parameters equal, masters rtol 1e-6); an overflowing step leaves the
  parameters and halves the dynamic scale, as JAX's does.
- The legacy ``LossScaler`` / ``DynamicLossScaler`` aliases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from apex_tpu import fp16_utils as jfp16
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu_torch.fp16_utils import (
    FP16_Optimizer,
    DynamicLossScaler,
    LossScaler,
    convert_network,
    master_params_to_model_params,
    model_grads_to_master_grads,
    network_to_half,
    prep_param_lists,
)
from apex_tpu_torch.optimizers import FusedAdam, FusedSGD


def _params(lib):
    ones, zeros = ((jnp.ones, jnp.zeros) if lib == "jax"
                   else (torch.ones, torch.zeros))
    step = (jnp.asarray(0, jnp.int32) if lib == "jax"
            else torch.tensor(0, dtype=torch.int32))
    return {"dense": {"kernel": ones((4, 3)), "bias": zeros((3,))},
            "batchnorm": {"scale": ones((3,)), "bias": zeros((3,))},
            "ln_f": {"w": ones((3,))}, "step": step}


def _names(tree, lib):
    if lib == "jax":
        return {jax.tree_util.keystr(p): jnp.dtype(x.dtype).name
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    out = {}
    for a, sub in tree.items():
        if isinstance(sub, dict):
            for b, x in sub.items():
                out[f"['{a}']['{b}']"] = str(x.dtype).replace("torch.", "")
        else:
            out[f"['{a}']"] = str(sub.dtype).replace("torch.", "")
    return out


def test_network_to_half_and_convert_network_match_jax():
    for keep in ("default", None, "custom"):
        kw = {} if keep == "default" else dict(
            keep_fp32=None if keep is None
            else (lambda path, leaf: "dense" in "/".join(map(str, path))))
        jkw = {} if keep == "default" else dict(
            keep_fp32=None if keep is None
            else (lambda path, leaf: "dense" in jax.tree_util.keystr(path)))
        got = _names(convert_network(_params("torch"), torch.bfloat16, **kw),
                     "torch")
        want = _names(jfp16.convert_network(_params("jax"), jnp.bfloat16,
                                            **jkw), "jax")
        assert got == want, keep
    assert _names(network_to_half(_params("torch"), torch.float16),
                  "torch") == _names(jfp16.network_to_half(
                      _params("jax"), jnp.float16), "jax")
    model = torch.nn.ModuleDict({"dense": torch.nn.Linear(3, 4),
                                 "ln": torch.nn.LayerNorm(4)})
    assert convert_network(model) is model
    assert model["dense"].weight.dtype == torch.bfloat16
    assert model["ln"].weight.dtype == torch.float32
    assert isinstance(model["dense"].weight, torch.nn.Parameter)


def test_prep_param_lists_and_master_copies():
    model = network_to_half(_params("torch"), torch.bfloat16)
    model_out, master = prep_param_lists(model)
    assert model_out is model
    assert master["dense"]["kernel"].dtype == torch.float32
    assert master["step"].dtype == torch.int32
    grads = {"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}
    mg = model_grads_to_master_grads(grads)
    assert mg["w"].dtype == torch.float32
    m = {"w": torch.ones(4) - 0.1 * mg["w"]}
    back = master_params_to_model_params(m, {"w": torch.ones(
        4, dtype=torch.bfloat16)})
    jback = jfp16.master_params_to_model_params(
        {"w": jnp.ones(4) - 0.1 * jnp.full((4,), 0.5)},
        {"w": jnp.ones(4, jnp.bfloat16)})
    assert back["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["w"].float().numpy(),
                                  np.asarray(jback["w"], np.float32))


def test_fp16_optimizer_at_scale_one_equals_its_inner_optimizer():
    rng = np.random.RandomState(0)
    w = rng.randn(8).astype(np.float32)
    grads = [rng.randn(8).astype(np.float32) for _ in range(3)]
    ref = torch.nn.Parameter(torch.tensor(w))
    inner = FusedSGD([ref], lr=0.1, momentum=0.9)
    p = torch.nn.Parameter(torch.tensor(w))
    wrapped = FP16_Optimizer(FusedSGD([p], lr=0.1, momentum=0.9))
    for g in grads:
        ref.grad = torch.tensor(g)
        inner.step()
        p.grad = torch.tensor(g)
        assert not bool(wrapped.step())
    assert torch.equal(p.detach(), ref.detach())


def test_fp16_optimizer_over_bf16_params_matches_jax():
    rng = np.random.RandomState(1)
    w = rng.randn(8).astype(np.float32)
    grads = [rng.randn(8).astype(np.float32) * 128 for _ in range(3)]
    jopt = jfp16.FP16_Optimizer(JaxFusedAdam(lr=0.01),
                                static_loss_scale=128.0)
    jp = {"w": jnp.asarray(w, jnp.bfloat16)}
    jst = jopt.init(jp)
    p = torch.nn.Parameter(torch.tensor(w).to(torch.bfloat16))
    opt = FP16_Optimizer(FusedAdam([p], lr=0.01), static_loss_scale=128.0)
    assert float(opt.scale_loss(torch.tensor(1.0))) == 128.0
    for g in grads:
        jp, jst = jopt.step({"w": jnp.asarray(g, jnp.bfloat16)}, jst, jp)
        p.grad = torch.tensor(g).to(torch.bfloat16)
        opt.step()
    assert p.dtype == torch.bfloat16
    np.testing.assert_array_equal(p.detach().float().numpy(),
                                  np.asarray(jp["w"], np.float32))
    np.testing.assert_allclose(opt.master_params[0].detach().numpy(),
                               np.asarray(jst.master_params["w"]), rtol=1e-6)


def test_fp16_optimizer_overflow_skips_and_backs_off():
    p = torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))
    opt = FP16_Optimizer(FusedSGD([p], lr=0.5), dynamic_loss_scale=True,
                         dynamic_loss_args={"init_scale": 2.0 ** 10})
    jopt = jfp16.FP16_Optimizer(JaxFusedSGD(lr=0.5), dynamic_loss_scale=True,
                                dynamic_loss_args={"init_scale": 2.0 ** 10})
    jp = {"w": jnp.ones((4,), jnp.bfloat16)}
    jp2, jst2 = jopt.step({"w": jnp.full((4,), jnp.inf, jnp.bfloat16)},
                          jopt.init(jp), jp)
    p.grad = torch.full((4,), float("inf"), dtype=torch.bfloat16)
    assert bool(opt.step())
    np.testing.assert_array_equal(p.detach().float().numpy(),
                                  np.asarray(jp2["w"], np.float32))
    assert float(opt.loss_scale) == float(jst2.scaler_state.loss_scale) \
        == 2.0 ** 9
    opt.zero_grad()
    assert p.grad is None


def test_legacy_scaler_aliases():
    sc = LossScaler(64.0)
    st = sc.init(device="cpu")
    assert float(st.loss_scale) == 64.0
    assert float(sc.update(st, torch.tensor(True)).loss_scale) == 64.0
    dyn = DynamicLossScaler(init_scale=2.0 ** 8, scale_window=2)
    jdyn = jfp16.DynamicLossScaler(init_scale=2.0 ** 8, scale_window=2)
    st, jst = dyn.init(device="cpu"), jdyn.init()
    for found in (False, False, True):
        st = dyn.update(st, torch.tensor(found))
        jst = jdyn.update(jst, jnp.asarray(found))
        assert float(st.loss_scale) == float(jst.loss_scale)
    assert float(st.loss_scale) == 2.0 ** 8
    assert float(DynamicLossScaler().init(device="cpu").loss_scale) == \
        2.0 ** 32
