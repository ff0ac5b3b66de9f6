"""Self-speculative drafting for the batched serving engine.

Copied from ``apex_tpu/serving/speculation.py`` (stdlib only), kept in the
port so it never imports the JAX package: the same context gives the same
draft in both engines.

Decode is bandwidth-bound: one read of a slot's whole KV stream buys
ONE token. Speculative decoding amortizes that read — draft ``k - 1``
likely continuations cheaply, then verify all of them in ONE windowed
forward (the paged kernel's k-row append+attend window,
:mod:`apex_tpu_torch.ops.decode_attention`), emitting every prefix token the
target model agrees with. This module is the DRAFT side: a model-free
n-gram proposer over the request's own token history (prompt +
generated so far) — "self-speculative", no draft model to load, no
extra weights resident. Repetitive streams (templated output, code,
the repeated-text loadtest scenario) draft well; incompressible streams
fall back to one token per step, never worse than plain decode.

Correctness does not depend on the draft at all: the engine samples the
TARGET model at every window position with the exact per-position key
the sequential path would use, and accepts a drafted token only while
the token FED at the next window row equals what the target just
emitted. With a deterministic
draft this acceptance rule reproduces the sequential engine's stream
token-for-token — greedy AND sampled — so "distribution-preserving"
holds exactly, not just in expectation. (The port serves greedy requests
only until its sampler lands.)
"""

from __future__ import annotations

from typing import List, Sequence

__all__ = ["propose_draft"]

#: longest n-gram the proposer matches against the history
_MAX_ORDER = 3

#: how far back the proposer scans for a matching n-gram — bounds the
#: per-slot per-tick cost to O(n * order * tail) regardless of context
#: length (drafting runs on the host between device steps; it must stay
#: far cheaper than the decode step it feeds)
_TAIL = 128


def propose_draft(context: Sequence[int], n: int, *,
                  max_order: int = _MAX_ORDER) -> List[int]:
    """Predict the next ``n`` tokens of ``context`` by n-gram matching.

    For each position: find the MOST RECENT earlier occurrence of the
    longest current suffix (order ``max_order`` down to 1, within the
    last ``_TAIL`` tokens) and propose the token that followed it;
    with no match anywhere, repeat the last token (a cheap bet that is
    free when wrong — rejected drafts cost nothing beyond the window
    row they rode in). Proposals are appended to the working context so
    multi-token drafts extend their own predictions. Deterministic:
    same context -> same draft, which is what makes the engine's
    acceptance rule reproduce the sequential stream exactly.
    """
    if n <= 0:
        return []
    ctx = [int(t) for t in context[-(_TAIL + max_order):]]
    if not ctx:
        return [0] * n
    out: List[int] = []
    for _ in range(n):
        nxt = None
        lo = max(0, len(ctx) - _TAIL)
        for order in range(min(max_order, len(ctx) - 1), 0, -1):
            pat = ctx[-order:]
            # newest match first: recent repetition is the signal
            for i in range(len(ctx) - order - 1, lo - 1, -1):
                if ctx[i:i + order] == pat:
                    nxt = ctx[i + order]
                    break
            if nxt is not None:
                break
        if nxt is None:
            nxt = ctx[-1]
        out.append(nxt)
        ctx.append(nxt)
    return out
