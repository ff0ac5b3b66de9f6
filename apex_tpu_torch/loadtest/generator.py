"""Seeded open-loop traffic generation from a scenario.

The generator is the single source of synthetic serving traffic — the
loadtest runner replays its schedule against the supervised engine.

**Open loop**: arrival times are drawn up front as a Poisson process
(exponential inter-arrival gaps at each phase's rate) and never react to
completions — the defining property of a capacity test. A closed loop
(submit-on-completion) self-throttles and hides saturation; an open
loop keeps offering load, so queueing, shedding, and deadline misses
become measurable instead of invisible.

**Determinism**: every draw — arrival gaps, prompt tokens, output
budgets, deadlines, sampling params — comes from ONE ``random.Random``
seeded with the scenario seed, consumed in a fixed order. Same seed +
same scenario => byte-identical schedule (asserted in tier-1), which is
what makes a committed SLO baseline meaningful: reruns measure the same
offered load. ``request_id`` is the only field that varies between runs
(it is process-global by design, for log correlation); compare
schedules with :meth:`ScheduledRequest.signature`.

Host-side only: imports :mod:`apex_tpu_torch.serving.request` (plain
dataclasses), never the engine — generating a schedule touches no
device.

Copied from ``apex_tpu/loadtest/generator.py`` (stdlib only), so the port never imports
the JAX package.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Tuple

from apex_tpu_torch.loadtest.scenario import LoadPhase, Scenario
from apex_tpu_torch.serving.request import Request, SamplingParams

__all__ = ["ScheduledRequest", "TrafficGenerator"]


@dataclass(frozen=True)
class ScheduledRequest:
    """One arrival: the request plus its offset (seconds) from the run
    start and the phase that produced it."""

    at_s: float
    phase: str
    request: Request

    def signature(self) -> Tuple:
        """Everything that must be identical across same-seed runs —
        all sampled fields, excluding the process-global request_id."""
        r = self.request
        return (round(self.at_s, 9), self.phase, tuple(r.prompt),
                r.max_new_tokens, r.eos_token, r.deadline_s,
                r.sampling.temperature, r.sampling.top_k, r.sampling.seed,
                r.sampling.adapter_id, r.sampling.priority)


def _choose(rng: random.Random, mix: Dict[int, float]) -> int:
    values = sorted(mix)    # sorted: draw order independent of dict order
    return rng.choices(values, weights=[mix[v] for v in values])[0]


class TrafficGenerator:
    """Materializes a :class:`~apex_tpu_torch.loadtest.scenario.Scenario`'s
    phases into one time-ordered arrival schedule."""

    def __init__(self, scenario: Scenario):
        self.scenario = scenario

    def schedule(self) -> List[ScheduledRequest]:
        """The full arrival schedule, time-ordered (phases are
        sequential: each phase's clock starts where the previous one's
        last arrival landed)."""
        rng = random.Random(self.scenario.seed)
        out: List[ScheduledRequest] = []
        t = 0.0
        for phase in self.scenario.phases:
            # the phase's shared prompt opening, drawn ONCE — when the
            # knob is 0 no draw happens at all, so schedules of
            # pre-existing scenarios stay byte-identical
            shared = [rng.randrange(self.scenario.model.vocab_size)
                      for _ in range(phase.shared_prefix_len)]
            for _ in range(phase.n_requests):
                t += rng.expovariate(phase.rate_rps)
                out.append(ScheduledRequest(
                    at_s=t, phase=phase.name,
                    request=self._request(phase, rng, shared)))
        return out

    def requests(self) -> List[Request]:
        """Just the requests, arrival order — what a lockstep consumer
        (the benchmark's ``generate()`` arm) needs."""
        return [s.request for s in self.schedule()]

    def _request(self, phase: LoadPhase, rng: random.Random,
                 shared: List[int]) -> Request:
        prompt_len = _choose(rng, phase.prompt_lens)
        # scenario validation caps shared_prefix_len at the shortest
        # prompt length, so the suffix draw count is never negative
        prompt = shared + [rng.randrange(self.scenario.model.vocab_size)
                           for _ in range(prompt_len - len(shared))]
        if phase.prompt_period > 0:
            # repeated-text shape: tile the prompt's first period across
            # its full length (period 0 draws nothing extra, so existing
            # scenarios keep byte-identical schedules)
            period = prompt[:phase.prompt_period]
            prompt = (period * (prompt_len // len(period) + 1))[:prompt_len]
        max_new = _choose(rng, phase.max_new_tokens)
        # draw order is fixed and unconditional draws come first, so a
        # mix change in one field cannot shift another field's stream
        # more than necessary
        deadline_draw = rng.random()
        deadline = None
        if phase.deadline_fraction > 0:
            d = rng.uniform(phase.deadline_min_s, phase.deadline_max_s)
            if deadline_draw < phase.deadline_fraction:
                deadline = d
        greedy_draw = rng.random()
        temp = rng.choice(phase.temperatures) if phase.temperatures \
            else 0.7
        top_k = rng.choice(phase.top_ks) if phase.top_ks else 0
        seed = rng.randrange(2 ** 31)
        # the adapter draw comes LAST and only for phases that declare a
        # mix, so adapter-free scenarios consume the exact same stream
        # as before multi-LoRA existed (byte-identical schedules)
        adapter_id = None
        if phase.adapter_mix:
            ids = sorted(phase.adapter_mix)
            drawn = rng.choices(
                ids, weights=[phase.adapter_mix[a] for a in ids])[0]
            adapter_id = None if drawn == "base" else drawn
        # priority is a FIXED per-phase knob, not a draw — stamping a
        # class consumes no randomness, so pre-priority scenarios keep
        # byte-identical schedules
        priority = phase.priority if phase.priority is not None \
            else SamplingParams().priority
        if greedy_draw < phase.greedy_fraction:
            sampling = SamplingParams(adapter_id=adapter_id,
                                      priority=priority)       # greedy
        else:
            sampling = SamplingParams(
                temperature=temp, top_k=top_k if top_k > 0 else None,
                seed=seed, adapter_id=adapter_id, priority=priority)
        return Request(prompt=prompt, max_new_tokens=max_new,
                       sampling=sampling, eos_token=phase.eos_token,
                       deadline_s=deadline)
