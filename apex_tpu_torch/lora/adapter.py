"""Adapter format and the device-resident adapter bank for Multi-LoRA.

Counterpart of ``apex_tpu/lora/adapter.py``. An *adapter* is a set of
low-rank factor pairs, one per target matrix: for a target weight ``W
[out, in]`` the factors are ``A [in, r]`` and ``B [r, out]``, and the
adapted projection is ``y = x @ W.T + (x @ A) @ B`` — LoRA with the delta
kept factored. The targets are the two column-parallel projections every
layer owns: the fused QKV (``query_key_value``) and the MLP up-projection
(``dense_h_to_4h``). A factor tree is ``{target: {"A": [L, in, r], "B":
[L, r, out]}}`` of fp32 tensors, the JAX package's layout
(:func:`apex_tpu_torch.convert.adapter_from_jax` carries one across).

:class:`AdapterStore` registers adapters on the host and keeps them as a
stacked bank ``[num_layers, max_adapters + 1, ...]`` per factor on its
device. Row ``max_adapters`` is the reserved all-zeros null adapter:
requests without an ``adapter_id`` gather it, and their delta is exactly
zero, so base traffic shares the one batched step with tenant traffic.
``load`` and ``unload`` write one bank row in place (``copy_`` /
``zero_``), so an engine holding the bank sees the change on its next
step with no reallocation.

The draws (:func:`init_adapter`, :func:`random_adapter`) come from a
``torch.Generator`` on the generator's device, as the port's model
weights do, and are then moved to ``device``: the same seed gives the
same factors on any device, but not the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from apex_tpu_torch.ops._support import resolve_device
from apex_tpu_torch.utils.activations import is_gated

__all__ = [
    "LORA_TARGETS",
    "AdapterStore",
    "UnknownAdapterError",
    "init_adapter",
    "random_adapter",
    "merge_adapter",
    "target_dims",
]

#: layer-local projections that take a low-rank delta, in bank order
LORA_TARGETS = ("query_key_value", "dense_h_to_4h")

#: each target's module path inside a transformer layer
_PATHS = {"query_key_value": "self_attention.query_key_value",
          "dense_h_to_4h": "mlp.dense_h_to_4h"}

Factors = Dict[str, Dict[str, torch.Tensor]]


class UnknownAdapterError(KeyError):
    """``adapter_id`` is not (or no longer) loaded in the AdapterStore."""


def target_dims(config) -> Dict[str, Tuple[int, int]]:
    """``{target: (in_dim, out_dim)}``. MoE models carry no
    ``dense_h_to_4h`` (expert weights are routed, not adapted); the port's
    config has no experts yet, so both targets are adapted."""
    c = config
    qpg = c.num_attention_heads // c.kv_heads
    dims = {"query_key_value": (c.hidden_size,
                                c.kv_heads * (qpg + 2) * c.head_dim)}
    if not getattr(c, "num_moe_experts", 0):
        gated = 2 if is_gated(c.activation) else 1
        dims["dense_h_to_4h"] = (c.hidden_size, gated * c.ffn_size)
    return dims


def _normal(shape, scale: float, generator: Optional[torch.Generator],
            device: torch.device) -> torch.Tensor:
    """``scale * N(0, 1)`` in fp32, drawn on the generator's device."""
    draw = torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=None if generator is None
                       else generator.device)
    return (scale * draw).to(device)


def init_adapter(config, rank: int,
                 generator: Optional[torch.Generator] = None, *,
                 device="cuda") -> Factors:
    """Fresh trainable factors ``{target: {"A": [L, in, r], "B": [L, r,
    out]}}``: A gaussian x 0.02, B zeros, so the initial delta is exactly
    zero (fine-tuning starts from the base model)."""
    dev = resolve_device(device)
    L = config.num_layers
    return {t: {"A": _normal((L, din, rank), 0.02, generator, dev),
                "B": torch.zeros((L, rank, dout), dtype=torch.float32,
                                 device=dev)}
            for t, (din, dout) in target_dims(config).items()}


def random_adapter(config, rank: int,
                   generator: Optional[torch.Generator] = None,
                   scale: float = 0.02, *, device="cuda") -> Factors:
    """Factors with both halves nonzero (a nonzero delta) — what traffic
    generators and comparisons want; :func:`init_adapter` is a zero
    delta."""
    dev = resolve_device(device)
    L = config.num_layers
    out = {}
    for t, (din, dout) in target_dims(config).items():
        a = _normal((L, din, rank), scale, generator, dev)
        out[t] = {"A": a, "B": _normal((L, rank, dout), scale, generator,
                                       dev)}
    return out


def _check_factors(config, rank: int, factors) -> None:
    dims = target_dims(config)
    if set(factors) != set(dims):
        raise ValueError(
            f"adapter targets {sorted(factors)} != expected "
            f"{sorted(dims)} for this config")
    L = config.num_layers
    for t, (din, dout) in dims.items():
        a = factors[t]["A"]
        b = factors[t]["B"]
        if tuple(a.shape) != (L, din, rank):
            raise ValueError(
                f"{t}.A shape {tuple(a.shape)} != {(L, din, rank)}")
        if tuple(b.shape) != (L, rank, dout):
            raise ValueError(
                f"{t}.B shape {tuple(b.shape)} != {(L, rank, dout)}")


def merge_adapter(params: Dict[str, torch.Tensor],
                  factors: Factors) -> Dict[str, torch.Tensor]:
    """Fold an adapter into full weights: per layer and target ``W' = W +
    (A @ B).T`` (``W`` is ``[out, in]``), the delta in fp32 and the sum
    cast back to ``W``'s dtype. ``params`` is a model's parameter dict
    (``dict(model.named_parameters())`` or its ``state_dict()``); returns a
    new dict whose other entries are the same tensors (the input is left
    untouched). A merged model served with no adapters is the ground truth
    the per-slot factored path is held to; differentiable in the factors
    (what :func:`~apex_tpu_torch.lora.lora_finetune` trains through)."""
    out = dict(params)
    for t, f in factors.items():
        for i in range(f["A"].shape[0]):
            key = f"transformer.layers.{i}.{_PATHS[t]}.weight"
            w = params[key]
            delta = torch.matmul(f["A"][i].float(), f["B"][i].float()).t()
            out[key] = (w.float() + delta).to(w.dtype)
    return out


class AdapterStore:
    """Host-side registry and device-resident stacked adapter bank.

    The bank is ``{target: {"A": [L, n+1, in, r], "B": [L, n+1, r,
    out]}}`` (``n = max_adapters``) in fp32 on ``device``. The engine
    reads it on every step and gathers each slot's row, so ``load`` and
    ``unload`` between ticks take effect on the next step."""

    def __init__(self, config, rank: int, max_adapters: int = 8, *,
                 device="cuda"):
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        if max_adapters < 1:
            raise ValueError(
                f"max_adapters must be >= 1, got {max_adapters}")
        self.config = config
        self.rank = int(rank)
        self.max_adapters = int(max_adapters)
        self.device = resolve_device(device)
        self._ids: Dict[str, int] = {}
        self._free: List[int] = list(range(max_adapters))
        L = config.num_layers
        self._bank = {
            t: {"A": torch.zeros((L, max_adapters + 1, din, rank),
                                 dtype=torch.float32, device=self.device),
                "B": torch.zeros((L, max_adapters + 1, rank, dout),
                                 dtype=torch.float32, device=self.device)}
            for t, (din, dout) in target_dims(config).items()
        }

    # -- identity ---------------------------------------------------------
    @property
    def null_index(self) -> int:
        """Bank row of the reserved all-zeros adapter (base traffic)."""
        return self.max_adapters

    @property
    def bank(self) -> Factors:
        """The device bank; its tensors keep their storage for the
        store's life."""
        return self._bank

    def ids(self) -> List[str]:
        return sorted(self._ids)

    def __contains__(self, adapter_id: str) -> bool:
        return adapter_id in self._ids

    def __len__(self) -> int:
        return len(self._ids)

    def index_of(self, adapter_id: Optional[str]) -> int:
        """Bank row for a request's ``adapter_id`` (None -> null row)."""
        if adapter_id is None:
            return self.null_index
        try:
            return self._ids[adapter_id]
        except KeyError:
            raise UnknownAdapterError(
                f"adapter {adapter_id!r} is not loaded "
                f"(loaded: {self.ids()})") from None

    # -- lifecycle --------------------------------------------------------
    @torch.no_grad()
    def load(self, adapter_id: str, factors: Factors) -> int:
        """Register ``factors`` under ``adapter_id`` and write its bank
        row in place (re-loading an existing id overwrites it). Returns
        the bank index. Raises when full or on a shape/target mismatch."""
        if not isinstance(adapter_id, str) or not adapter_id:
            raise ValueError("adapter_id must be a non-empty string")
        _check_factors(self.config, self.rank, factors)
        if adapter_id in self._ids:
            ix = self._ids[adapter_id]
        else:
            if not self._free:
                raise ValueError(
                    f"adapter bank full ({self.max_adapters} slots); "
                    f"unload one of {self.ids()}")
            ix = self._free.pop(0)
            self._ids[adapter_id] = ix
        for t, f in factors.items():
            for k in ("A", "B"):
                self._bank[t][k][:, ix].copy_(f[k])
        return ix

    @torch.no_grad()
    def unload(self, adapter_id: str) -> None:
        """Drop an adapter: zero its bank row and free the index. Requests
        already decoding against the row keep running — against a zero
        delta from the next step on (they degrade to base-model output);
        new submits with this id fail :class:`UnknownAdapterError`."""
        if adapter_id not in self._ids:
            raise UnknownAdapterError(
                f"adapter {adapter_id!r} is not loaded "
                f"(loaded: {self.ids()})")
        ix = self._ids.pop(adapter_id)
        for factor in self._bank.values():
            for k in ("A", "B"):
                factor[k][:, ix].zero_()
        self._free.append(ix)
        self._free.sort()
