"""Threefry2x32 random numbers as integer torch math.

Counterpart of ``jax.random`` under its defaults (``threefry2x32`` keys,
``jax_threefry_partitionable=True``): the same keys, bits, uniforms and
gumbel noise, so a sampled stream is token-exact against the JAX
package. Torch has no full uint32 arithmetic on the CPU, so every word is
an int64 masked to 32 bits (as ``hash_keep`` in ``ops/attention.py``).

A key is a two-element int64 tensor ``[k1, k2]``; a ``[..., 2]`` tensor
holds a batch of keys, and every function below then maps over the
leading dims (what ``jax.vmap`` over a key batch gives). Functions run on
the key's device.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "split", "random_bits",
           "uniform", "bernoulli", "randint", "gumbel", "categorical"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _threefry(k1, k2, x1, x2):
    """The threefry2x32 block function over broadcastable word tensors:
    20 rounds, a key injection after every 4."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def _words(key: torch.Tensor):
    key = key.long()
    return key[..., 0], key[..., 1]


def threefry2x32(key: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """Hash the uint32 ``counters`` under ``key`` (``jax.prng.threefry_2x32``):
    the flattened counters split into halves (zero-padded to even length),
    the halves run as the block's two words, and the two outputs concatenate
    back into ``counters``' shape."""
    k1, k2 = _words(key)
    flat = counters.long().reshape(-1) & _M32
    n = flat.numel()
    if n % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    x1, x2 = flat.chunk(2)
    out = torch.cat(_threefry(k1, k2, x1, x2))
    return out[:n].reshape(counters.shape)


def prng_key(seed: Union[int, torch.Tensor], device=None) -> torch.Tensor:
    """The raw key ``jax.random.PRNGKey(seed)`` holds: ``[0, seed mod
    2**32]`` for a 32-bit ``seed`` (JAX without x64 takes seeds as int32).
    A ``[n]`` tensor of seeds gives ``[n, 2]`` keys."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device)
    return torch.stack([torch.zeros_like(seed), seed & _M32], dim=-1)


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]
            ) -> torch.Tensor:
    """``jax.random.fold_in``: hash ``data`` (taken as uint32) into ``key``.
    ``data`` broadcasts against the key batch."""
    k1, k2 = _words(key)
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) \
        & _M32
    y1, y2 = _threefry(k1, k2, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable layout): ``[num, 2]`` keys, key
    ``i`` the block function of the counter words ``(0, i)`` under ``key``,
    so ``split(key, n)[i]`` equals ``fold_in(key, i)``."""
    if key.dim() != 1:
        raise ValueError(f"split takes one key [2], got {tuple(key.shape)}")
    k1, k2 = _words(key)
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = _threefry(k1, k2, torch.zeros_like(i), i)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (``jax.random.bits``, partitionable
    layout): the counters are the uint64 iota over the flattened ``shape``
    split into (hi, lo) words, and the bits are ``bits1 ^ bits2``. Returns
    int64 values in ``[0, 2**32)`` of shape ``key.shape[:-1] + shape``."""
    shape = tuple(shape)
    k1, k2 = _words(key)
    lead = k1.shape
    n = 1
    for d in shape:
        n *= d
    if n >= 2 ** 32:
        raise NotImplementedError("random bits past 2**32 elements")
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    k1 = k1.reshape(lead + (1,))
    k2 = k2.reshape(lead + (1,))
    b1, b2 = _threefry(k1, k2, torch.zeros_like(lo), lo)
    return (b1 ^ b2).reshape(lead + shape)


_FLOAT_LAYOUT = {torch.float32: (32, 23, torch.int32),
                 torch.float16: (16, 10, torch.int16),
                 torch.bfloat16: (16, 7, torch.int16)}


def uniform(key: torch.Tensor, shape: Sequence[int],
            dtype: torch.dtype = torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in ``[minval, maxval)``: the random mantissa
    bits OR'd into 1.0, minus 1, scaled and shifted, then floored at
    ``minval``. Float32, float16 and bfloat16 (whose 7 mantissa bits come
    from 8 random bits, as in JAX)."""
    if dtype not in _FLOAT_LAYOUT:
        raise TypeError(f"uniform takes float32, float16 or bfloat16, got "
                        f"{dtype}")
    nbits, nmant, word = _FLOAT_LAYOUT[dtype]
    rng_bits = nbits if nmant >= 8 else 8
    bits = random_bits(key, shape)
    if rng_bits != 32:
        bits = bits & ((1 << rng_bits) - 1)
    one = torch.tensor(1.0, dtype=dtype).view(word).item() & ((1 << nbits)
                                                               - 1)
    float_bits = (bits >> (rng_bits - nmant)) | one
    floats = float_bits.to(word).view(dtype) - 1.0
    lo = torch.tensor(minval, dtype=dtype, device=key.device)
    hi = torch.tensor(maxval, dtype=dtype, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def bernoulli(key: torch.Tensor, p: float,
              shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``:
    ``uniform(key, shape) < p``, both in float32 (a Python float is a
    weakly typed float32 in JAX without x64, and the uniform takes ``p``'s
    dtype). A bool tensor."""
    u = uniform(key, shape, torch.float32)
    return u < torch.tensor(p, dtype=torch.float32, device=key.device)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``: the
    key split in two, 32 random bits from each, and ``(hi % span *
    (2**32 % span) + lo % span) % span`` added to ``minval``, every
    product and sum wrapping as uint32 and the last add as int32, as JAX's
    do. Bounds are clipped to int32; ``maxval <= minval`` gives
    ``minval``. An int32 tensor."""
    lo_d, hi_d = -2 ** 31, 2 ** 31 - 1
    minval = min(max(int(minval), lo_d), hi_d)
    maxval = min(max(int(maxval), lo_d), hi_d)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    offset = ((((higher % span) * mult) & _M32) + lower % span) & _M32
    out = (minval + offset % span) & _M32
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def gumbel(key: torch.Tensor, shape: Sequence[int],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` in its default ``"low"`` mode:
    ``-log(-log(uniform(tiny, 1)))`` in ``dtype``."""
    u = uniform(key, shape, dtype, torch.finfo(dtype).tiny, 1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: ``argmax(logits +
    gumbel)``. One key ``[2]`` draws the noise over the whole of
    ``logits`` (counters over every element); a batch of keys ``[n, 2]``
    draws each row of ``logits [n, V]`` with its own key (a vmap)."""
    shape = logits.shape[key.dim() - 1:]
    noise = gumbel(key, shape, logits.dtype)
    return torch.argmax(noise + logits, dim=-1)
