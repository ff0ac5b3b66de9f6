"""Content-addressed prompt-prefix hashing for the prefix cache.

Copied from ``apex_tpu/serving/prefix.py`` (stdlib only), kept in the port
so it never imports the JAX package; the chains are the same numbers, so
the two engines intern and match the same prefixes.

One hash algorithm, three consumers:

- the **engine** hashes an admitted prompt's page-aligned prefix into a
  chain of per-page digests and asks the
  :class:`~apex_tpu_torch.serving.slots.PagePool` intern index for the longest
  interned run;
- the **pool** keys its intern index by chain tuples;
- the fleet **router** hashes the same chain to score prefix affinity —
  a replica that recently served the same prefix probably still holds
  its pages interned, so routing the request there turns a would-be
  miss into a hit.

The chain is *cumulative*: entry ``i`` digests pages ``0..i``, so two
prompts share a leading chain run exactly when they share the leading
token pages — a single mismatched token anywhere in page ``j`` changes
every entry from ``j`` on. Hashes are salted with a model/config
fingerprint (:func:`prefix_salt`), never with sampling state: K/V for a
prompt depend only on the tokens and the weights, so a greedy and a
sampled request over the same prompt MUST share pages. blake2b keeps
collisions out of reach for any realistic fleet lifetime; everything
here is stdlib + host-side.
"""

from __future__ import annotations

import hashlib
from typing import Sequence, Tuple

__all__ = ["prefix_hash_chain", "prefix_salt", "adapter_salt",
           "common_chain_len"]


def prefix_salt(config) -> str:
    """A model fingerprint that changes whenever cached K/V could: the
    architecture dims that shape the cache plus the parameter-defining
    seed is out of scope (one engine serves one weight set; a fleet
    serves replicas of the same weights). Sampling knobs are deliberately
    absent — K/V are sampling-invariant."""
    return (f"{getattr(config, 'num_layers', 0)}:"
            f"{getattr(config, 'hidden_size', 0)}:"
            f"{getattr(config, 'num_attention_heads', 0)}:"
            f"{getattr(config, 'kv_heads', 0)}:"
            f"{getattr(config, 'vocab_size', 0)}:"
            f"{getattr(config, 'position_embedding_type', '')}")


def adapter_salt(salt: str, adapter_id=None) -> str:
    """Fold a request's LoRA ``adapter_id`` into the chain salt. K/V are
    sampling-invariant but NOT adapter-invariant — the per-slot QKV delta
    writes adapter-specific K/V into the pages — so two tenants with
    identical prompts under different adapters must never share a chain
    (a naive model-only salt would alias their pages). ``None`` (base
    traffic) keeps the plain model salt, so all base requests still
    share."""
    if adapter_id is None:
        return salt
    return f"{salt}|adapter:{adapter_id}"


def prefix_hash_chain(tokens: Sequence[int], page_size: int,
                      salt: str = "") -> Tuple[int, ...]:
    """Rolling per-page digest chain over ``tokens``.

    Returns one 64-bit int per FULL page: entry ``i`` is
    ``H(salt, tokens[0 : (i + 1) * page_size])`` computed incrementally
    (each entry chains the previous digest, so it covers the whole
    prefix, not just its own page). The trailing partial page is never
    hashed — only immutable page-aligned runs are internable.
    """
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    full = len(tokens) // page_size
    if full == 0:
        return ()
    chain = []
    h = hashlib.blake2b(salt.encode("utf-8"), digest_size=8)
    for i in range(full):
        page = tokens[i * page_size:(i + 1) * page_size]
        h.update(b"".join(int(t).to_bytes(8, "little", signed=True)
                          for t in page))
        # fork the running state so the chain stays cumulative without
        # rehashing the prefix per entry
        chain.append(int.from_bytes(h.copy().digest(), "little"))
    return tuple(chain)


def common_chain_len(a: Sequence[int], b: Sequence[int]) -> int:
    """Length of the common leading run of two chains — the number of
    shared full pages (the router's affinity numerator)."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n
