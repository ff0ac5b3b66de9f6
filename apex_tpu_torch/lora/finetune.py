"""Batched multi-job LoRA fine-tuning against one frozen base model.

Counterpart of ``apex_tpu/lora/finetune.py``: ``n_jobs`` adapters are
stacked on a leading axis and the cohort steps as one loop. Each job's
loss is the model run on ``merge_adapter(base, factors_j)`` through
:func:`torch.func.functional_call`, so gradients flow only into the
factors; the step backpropagates the mean over the jobs once, the mean the
JAX package differentiates. The JAX package ``vmap``s the jobs; the port's
kernels are ``torch.autograd.Function`` s over ctypes launches, which
``torch.func.vmap`` cannot enter, so the jobs run one after another inside
the step.

The factor leaves ride the flat-bucket path: one contiguous fp32 buffer
(:func:`~apex_tpu_torch.multi_tensor_apply.flatten_by_dtype`) is the one
trainable parameter, the factors the forward reads are its
:func:`~apex_tpu_torch.multi_tensor_apply.unflatten_by_dtype` views, and
:class:`~apex_tpu_torch.optimizers.FusedAdam` steps it — one
``multi_tensor_adam`` launch a step on the card.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from apex_tpu_torch.lora.adapter import Factors, init_adapter, merge_adapter
from apex_tpu_torch.multi_tensor_apply import flatten_by_dtype, \
    unflatten_by_dtype
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.utils.tree import tree_map

__all__ = ["lora_finetune"]


def lora_finetune(model: nn.Module, tokens: torch.Tensor,
                  labels: torch.Tensor, *, rank: int = 4, steps: int = 10,
                  lr: float = 1e-2,
                  optimizer: Optional[Callable[[list], torch.optim.Optimizer]]
                  = None,
                  generator: Optional[torch.Generator] = None,
                  factors: Optional[Factors] = None):
    """Fine-tune ``n_jobs`` adapters of ``model`` in one batched loop.

    ``tokens``/``labels``: ``[n_jobs, batch, seq]`` integer tensors, each
    job's own data. The model's own parameters are the frozen base: they
    are detached inside the forward and never handed to the optimizer.
    Returns ``(factors, losses)``: ``factors`` is the stacked adapter tree
    (leaves ``[n_jobs, L, ...]`` on the model's device; job ``j`` is
    ``tree_map(lambda x: x[j], factors)``, ready for
    :meth:`AdapterStore.load`) and ``losses`` the ``[steps, n_jobs]``
    per-job losses, each taken before its step's update.

    ``optimizer`` builds the optimizer from the parameter list (default
    ``FusedAdam(params, lr=lr)``); ``factors`` (the same stacked layout)
    resumes instead of drawing fresh ones with :func:`init_adapter` from
    ``generator`` (default seed 0) job by job.
    """
    if labels.shape != tokens.shape:
        raise ValueError(
            f"labels shape {tuple(labels.shape)} != tokens shape "
            f"{tuple(tokens.shape)}")
    n_jobs = tokens.shape[0]
    device = next(model.parameters()).device
    if factors is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        jobs = [init_adapter(model.config, rank, generator, device=device)
                for _ in range(n_jobs)]
        factors = {t: {k: torch.stack([j[t][k] for j in jobs])
                       for k in ("A", "B")} for t in jobs[0]}
    base = {name: p.detach() for name, p in model.named_parameters()}
    # the factor leaves ride the flat-bucket path: one contiguous buffer
    # per dtype, the layout multi_tensor_apply hands the fused kernels
    buffers, metas, aux = flatten_by_dtype(
        tree_map(lambda x: x.detach().float(), factors))
    flat = {k: nn.Parameter(v) for k, v in buffers.items()}
    opt = (optimizer or (lambda ps: FusedAdam(ps, lr=lr)))(
        list(flat.values()))
    tokens, labels = tokens.to(device), labels.to(device)
    history = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        stacked = unflatten_by_dtype(flat, metas, aux)
        losses = []
        for j in range(n_jobs):
            merged = merge_adapter(base, tree_map(lambda x: x[j], stacked))
            losses.append(torch.func.functional_call(
                model, merged, (tokens[j], labels[j])))
        losses = torch.stack(losses)
        losses.mean().backward()
        opt.step()
        history.append(losses.detach())
    with torch.no_grad():
        out = unflatten_by_dtype({k: v.detach().clone()
                                  for k, v in flat.items()}, metas, aux)
    losses = (torch.stack(history) if history
              else torch.zeros((0, n_jobs), device=device))
    return out, losses
