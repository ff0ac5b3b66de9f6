"""Per-tenant quotas: token-bucket rate limits and concurrency caps.

A multi-tenant fleet shares one pool of slots and KV pages; without
quotas a single tenant submitting at 10x everyone else (the classic
noisy neighbor) fills every queue and the OTHER tenants' deadline sheds
pay for it. :class:`QuotaLedger` is the fleet front door's per-tenant
admission gate: each tenant — keyed by the request's
``adapter_id``, with ``"base"`` for base-model traffic — gets

- a **token bucket** (``rate_rps`` refill, ``burst`` capacity): each
  admitted request consumes one bucket token, so sustained throughput is
  capped at ``rate_rps`` while short bursts up to ``burst`` pass;
- a **concurrent-request cap** (``max_inflight``): non-terminal requests
  the tenant may hold across the fleet at once;
- a **KV-page cap** (``max_pages``): the worst-case page footprint
  (``ceil(total_len / page_size)`` per request, the same worst case the
  engine's admission reservation uses) the tenant may pin at once.

An over-quota submit is **shed** (typed ``requests_shed_quota`` counter,
terminal ``rejected`` record, :class:`QuotaExceededError`) for hard
quotas, or **deferred** (parked in the fleet backlog, re-checked every
tick until the bucket refills) for ``soft=True`` quotas — throttled,
never lost. Every knob's zero value means "unlimited", so a partial
quota spec constrains only what it names. See
docs/serving.md#priority-preemption-and-quotas.

The ledger is pure host-side bookkeeping (no torch, no engine access) —
unit-testable with any clock value.

Copied from ``apex_tpu/serving/fleet/quota.py``, so the port never
imports the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from apex_tpu_torch.serving.supervisor import EngineUnavailableError

__all__ = ["QuotaExceededError", "TenantQuota", "QuotaConfig",
           "QuotaLedger", "QUOTA_ADMIT", "QUOTA_DEFER", "QUOTA_SHED",
           "BASE_TENANT"]

#: ledger verdicts for one submit
QUOTA_ADMIT = "admit"   # within quota: commit and dispatch
QUOTA_DEFER = "defer"   # soft limit hit: backlog until the bucket refills
QUOTA_SHED = "shed"     # hard limit hit: reject terminally

#: tenant key for base-model traffic (``adapter_id is None``)
BASE_TENANT = "base"


class QuotaExceededError(EngineUnavailableError):
    """A hard per-tenant quota rejected the submit. The request IS
    recorded terminally (``finish_reason="rejected"``, counter
    ``requests_shed_quota``) — the same fail-fast contract as every
    other admission shed in this stack."""


@dataclass(frozen=True)
class TenantQuota:
    """One tenant's limits (0 = unlimited for every knob).

    ``soft=True`` turns the shed verdict into a defer: the over-quota
    request waits in the fleet backlog and is re-checked every tick —
    throttled to the quota rate instead of rejected."""

    rate_rps: float = 0.0
    burst: float = 1.0
    max_inflight: int = 0
    max_pages: int = 0
    soft: bool = False

    def __post_init__(self):
        if self.rate_rps < 0:
            raise ValueError(
                f"rate_rps must be >= 0, got {self.rate_rps}")
        if self.burst < 1.0:
            raise ValueError(
                f"burst must be >= 1 (one request must fit), got "
                f"{self.burst}")
        if self.max_inflight < 0:
            raise ValueError(
                f"max_inflight must be >= 0, got {self.max_inflight}")
        if self.max_pages < 0:
            raise ValueError(
                f"max_pages must be >= 0, got {self.max_pages}")


@dataclass(frozen=True)
class QuotaConfig:
    """The fleet's quota table: per-tenant entries plus an optional
    ``default`` applied to tenants not named. No entry and no default
    means the tenant is unlimited."""

    tenants: Dict[str, TenantQuota] = field(default_factory=dict)
    default: Optional[TenantQuota] = None

    def __post_init__(self):
        for key, q in self.tenants.items():
            if not isinstance(key, str) or not key:
                raise ValueError(
                    f"tenant keys must be non-empty strings, got {key!r}")
            if not isinstance(q, TenantQuota):
                raise TypeError(
                    f"quota for tenant {key!r} must be a TenantQuota, "
                    f"got {type(q).__name__}")
        if self.default is not None \
                and not isinstance(self.default, TenantQuota):
            raise TypeError(
                f"default must be None or a TenantQuota, got "
                f"{type(self.default).__name__}")

    def quota_for(self, tenant: str) -> Optional[TenantQuota]:
        return self.tenants.get(tenant, self.default)


class QuotaLedger:
    """Runtime state of the quota table: one token bucket plus
    inflight/page ledgers per tenant. Deterministic given the caller's
    clock — time only enters through the ``now`` arguments."""

    def __init__(self, config: Optional[QuotaConfig] = None):
        self.config = config or QuotaConfig()
        self._tokens: Dict[str, float] = {}
        self._stamp: Dict[str, float] = {}
        self._inflight: Dict[str, int] = {}
        self._pages: Dict[str, int] = {}

    @staticmethod
    def tenant(request) -> str:
        """The request's tenant key: its ``adapter_id``, or
        :data:`BASE_TENANT` for base-model traffic."""
        return request.sampling.adapter_id or BASE_TENANT

    def inflight(self, tenant: str) -> int:
        return self._inflight.get(tenant, 0)

    def pages_held(self, tenant: str) -> int:
        return self._pages.get(tenant, 0)

    def bucket_tokens(self, tenant: str, now: float) -> Optional[float]:
        """Current bucket level after refill (None when the tenant has
        no rate limit) — the quota-math unit tests read this."""
        q = self.config.quota_for(tenant)
        if q is None or q.rate_rps <= 0:
            return None
        return self._refill(tenant, q, now)

    def _refill(self, tenant: str, q: TenantQuota, now: float) -> float:
        tokens = self._tokens.get(tenant, q.burst)
        stamp = self._stamp.get(tenant)
        if stamp is not None and now > stamp:
            tokens = min(q.burst, tokens + (now - stamp) * q.rate_rps)
        self._tokens[tenant] = tokens
        self._stamp[tenant] = now
        return tokens

    def verdict(self, tenant: str, now: float, *, pages: int = 0
                ) -> Tuple[str, Optional[str]]:
        """``(QUOTA_ADMIT | QUOTA_DEFER | QUOTA_SHED, limit_name)`` for
        one prospective submit. Pure check — nothing is consumed until
        :meth:`commit` (so a request shed downstream never burns a
        bucket token)."""
        q = self.config.quota_for(tenant)
        if q is None:
            return QUOTA_ADMIT, None
        over: Optional[str] = None
        if q.rate_rps > 0 and self._refill(tenant, q, now) < 1.0:
            over = "rate"
        elif q.max_inflight > 0 \
                and self.inflight(tenant) >= q.max_inflight:
            over = "inflight"
        elif q.max_pages > 0 \
                and self.pages_held(tenant) + pages > q.max_pages:
            over = "pages"
        if over is None:
            return QUOTA_ADMIT, None
        return (QUOTA_DEFER if q.soft else QUOTA_SHED), over

    def commit(self, tenant: str, now: float, *, pages: int = 0) -> None:
        """Consume the admission: one bucket token, one inflight slot,
        the request's worst-case pages. Pair every commit with exactly
        one :meth:`release` at the request's terminal state."""
        q = self.config.quota_for(tenant)
        if q is None:
            return
        if q.rate_rps > 0:
            self._tokens[tenant] = self._refill(tenant, q, now) - 1.0
        self._inflight[tenant] = self.inflight(tenant) + 1
        if pages:
            self._pages[tenant] = self.pages_held(tenant) + pages

    def release(self, tenant: str, *, pages: int = 0) -> None:
        """Return the inflight slot and pages (bucket tokens are spent,
        not returned — rate is an admission rate, not a concurrency
        bound)."""
        if self.config.quota_for(tenant) is None:
            return
        self._inflight[tenant] = max(0, self.inflight(tenant) - 1)
        if pages:
            self._pages[tenant] = max(0, self.pages_held(tenant) - pages)
