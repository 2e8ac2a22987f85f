"""Admission control for the scheduler seam
(``protocol_tpu/fleet/admission.py:52 TokenBucket``, ``:87
TenantAdmission``, copied).

Non-blocking: an over-rate call is refused, never queued; the servicer
answers the refusal with ``RESOURCE_EXHAUSTED``. ``rate=None`` (the
default) admits everything but still counts. Clocks are injectable so
tests drive the refill.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Optional


class TokenBucket:
    """``rate`` tokens/s refill up to ``burst``; ``try_take`` refuses, it
    never waits."""

    def __init__(self, rate: float, burst: float, clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = float(burst)
        self._last = clock()

    def try_take(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


class TenantAdmission:
    """Per-tenant token-bucket admission. ``rate=None`` admits everything
    but counts; ``per_tenant`` overrides (rate, burst) for named tenants.
    The tenant table is LRU-bounded by ``max_tenants``."""

    def __init__(
        self,
        rate: Optional[float] = None,
        burst: float = 16.0,
        per_tenant: Optional[dict] = None,
        clock: Callable[[], float] = time.monotonic,
        max_tenants: int = 512,
    ):
        self.rate = rate
        self.burst = float(burst)
        self.per_tenant = dict(per_tenant or {})
        self._clock = clock
        self._lock = threading.Lock()
        self.max_tenants = int(max_tenants)
        # tenant -> {"bucket": TokenBucket | None, "admitted": n, "refused": n}
        self._tenants: OrderedDict[str, dict] = OrderedDict()

    def _entry_locked(self, tenant: str) -> dict:
        e = self._tenants.get(tenant)
        if e is not None:
            self._tenants.move_to_end(tenant)
        else:
            spec = self.per_tenant.get(tenant)
            if spec is not None:
                bucket = TokenBucket(spec[0], spec[1], clock=self._clock)
            elif self.rate is not None:
                bucket = TokenBucket(self.rate, self.burst, clock=self._clock)
            else:
                bucket = None
            e = self._tenants[tenant] = {"bucket": bucket, "admitted": 0, "refused": 0}
            while len(self._tenants) > self.max_tenants:
                self._tenants.popitem(last=False)
        return e

    def admit(self, tenant: str) -> bool:
        """True = proceed; False = refuse this call."""
        with self._lock:
            e = self._entry_locked(tenant)
            bucket = e["bucket"]
        # the bucket has its own lock: tenants do not serialize on each other
        ok = bucket is None or bucket.try_take()
        with self._lock:
            e["admitted" if ok else "refused"] += 1
        return ok

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "rate": self.rate,
                "burst": self.burst,
                "tenants": {t: {"admitted": e["admitted"], "refused": e["refused"]}
                            for t, e in self._tenants.items()},
            }
