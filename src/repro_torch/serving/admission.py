"""Admission control for open-loop serving: keep the queue — and p99 —
bounded when the offered load exceeds what the device can serve.

An open-loop arrival process does not wait for completions, so past the
saturation point the backlog grows without bound and every latency
percentile of the *admitted* work grows with it: the experimental
evaluations of disk-resident graph ANN systems flag exactly this regime as
the one where system-level policy, not kernel quality, decides behaviour.
The `AdmissionController` sits between the arrival process and the dynamic
batcher and decides, AT ARRIVAL TIME, what happens to each query:

  token bucket   `rate_qps` tokens/s refill into a bucket of depth `burst`;
                 an arrival that finds no token is shed immediately
                 (explicit per-deployment rate limiting, policy-independent;
                 rate_qps=0 disables the bucket).
  bounded queue  at most `queue_cap` queries may be awaiting dispatch.
                 An arrival that finds the queue full is handled by
                 `policy`:

    "reject"      — shed the NEW arrival (newest-dropped; admitted work is
                    never revoked, so queue wait stays FIFO-predictable).
    "shed-oldest" — drop the OLDEST waiting query and admit the new one
                    (freshest-first under overload: the oldest query is the
                    one whose SLO is already lost).
    "degrade"     — admit everything, but serve under pressure with a
                    SHRUNKEN search: the batcher maps queue occupancy to a
                    degrade level, and each level multiplies the beam
                    (`L`, `beam_width`, `dw_max`) by the configured factor.
                    Degraded queries trade recall for service rate, which
                    is what re-bounds the queue without dropping anyone.

  An arrival that finds the whole system idle (empty queue AND idle
  executor) is always queue-admitted — even at queue_cap=0, where the
  queue holds no *waiting* query but the in-service slot still exists.

Every decision is counted (offered / admitted / shed, globally and per
tenant), so `OpenLoopReport` can state goodput against offered load and
p99 over the admitted work only.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, deque
from typing import Deque, Optional, Tuple

ADMISSION_POLICIES = ("none", "reject", "shed-oldest", "degrade")


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    policy: str = "reject"       # "none" | "reject" | "shed-oldest" | "degrade"
    queue_cap: int = 64          # max queries awaiting dispatch (>= 0)
    rate_qps: float = 0.0        # token-bucket refill rate (0 = no bucket)
    burst: int = 32              # token-bucket depth
    # beam multipliers by queue-pressure level (policy="degrade"): level 0
    # applies below queue_cap occupancy, level i at [i*cap, (i+1)*cap), the
    # last level everywhere beyond.
    degrade_levels: Tuple[float, ...] = (1.0, 0.5, 0.25)

    def __post_init__(self):
        if self.policy not in ADMISSION_POLICIES:
            raise ValueError(f"policy={self.policy!r} must be one of "
                             f"{ADMISSION_POLICIES}")
        if self.queue_cap < 0:
            raise ValueError(f"queue_cap={self.queue_cap} must be >= 0 "
                             f"(0 = no waiting room beyond the in-service "
                             f"slot)")
        if self.rate_qps < 0:
            raise ValueError(f"rate_qps={self.rate_qps} must be >= 0 "
                             f"(0 disables the token bucket)")
        if self.burst < 1:
            raise ValueError(f"burst={self.burst} must be >= 1 "
                             f"(a bucket that holds no token admits "
                             f"nothing)")
        if not self.degrade_levels:
            raise ValueError("degrade_levels must not be empty")
        if any(not 0.0 < m <= 1.0 for m in self.degrade_levels):
            raise ValueError(
                f"degrade_levels={self.degrade_levels} must all be in "
                f"(0, 1] (multipliers on the configured beam)")
        if self.degrade_levels[0] != 1.0:
            raise ValueError(
                f"degrade_levels[0]={self.degrade_levels[0]} must be 1.0 "
                f"(below queue_cap occupancy the search is undegraded)")
        if any(b > a for a, b in zip(self.degrade_levels,
                                     self.degrade_levels[1:])):
            raise ValueError(
                f"degrade_levels={self.degrade_levels} must be "
                f"non-increasing (more pressure never widens the beam)")


class AdmissionController:
    """Arrival-time admission state machine for `AnnServer.serve_open_loop`.

    Owns the pending queue (entries are (arrival_time_us, item, tenant)
    tuples in arrival order) plus the token bucket and all shed/admit
    counters. The serving loop calls `offer()` once per arrival in time
    order, reads `pressure_level()` at each dispatch, and drains with
    `take_batch()`. Virtual time: every timestamp is microseconds on the
    server's simulated clock."""

    def __init__(self, cfg: Optional[AdmissionConfig] = None):
        self.cfg = cfg or AdmissionConfig(policy="none")
        self.pending: Deque[Tuple[float, int, int]] = deque()
        self._tokens = float(self.cfg.burst)
        self._last_refill = 0.0
        self.offered = 0
        self.admitted = 0            # net of shed-oldest revocations, so
        #                              offered == admitted + shed always
        self.shed_rate = 0           # shed by the token bucket
        self.shed_queue = 0          # shed by the bounded queue
        # keyed by tenant id, like every other per-tenant structure in the
        # stack — ids may be sparse (an unpartitioned cache accepts any)
        self.t_offered = Counter()
        self.t_admitted = Counter()
        self.t_shed = Counter()

    @property
    def shed(self) -> int:
        return self.shed_rate + self.shed_queue

    def _take_token(self, t_us: float) -> bool:
        """Refill the bucket up to time `t_us` and try to take one token.
        Arrivals must be offered in non-decreasing time order."""
        if self.cfg.rate_qps <= 0:
            return True
        self._tokens = min(
            float(self.cfg.burst),
            self._tokens
            + (t_us - self._last_refill) * self.cfg.rate_qps * 1e-6)
        self._last_refill = t_us
        if self._tokens < 1.0:
            return False
        self._tokens -= 1.0
        return True

    def offer(self, t_us: float, item: int, tenant: int = 0,
              executor_idle: bool = False) -> bool:
        """Admission decision for one arrival at virtual time `t_us`.
        Returns whether the arrival was admitted (it may still be revoked
        later by a shed-oldest drop). `executor_idle` tells the controller
        the batch executor has no work in flight, which is what makes the
        idle-system bypass at queue_cap=0 well defined."""
        self.offered += 1
        self.t_offered[tenant] += 1
        if not self._take_token(t_us):
            self.shed_rate += 1
            self.t_shed[tenant] += 1
            return False
        cfg = self.cfg
        queue_bound = cfg.policy in ("reject", "shed-oldest")
        if queue_bound and len(self.pending) >= cfg.queue_cap \
                and not (executor_idle and not self.pending):
            if cfg.policy == "reject" or not self.pending:
                # nothing older to shed at queue_cap=0: shed the arrival
                self.shed_queue += 1
                self.t_shed[tenant] += 1
                return False
            _, _, old_tenant = self.pending.popleft()
            self.shed_queue += 1
            self.admitted -= 1
            self.t_shed[old_tenant] += 1
            self.t_admitted[old_tenant] -= 1
        self.pending.append((t_us, item, tenant))
        self.admitted += 1
        self.t_admitted[tenant] += 1
        return True

    def pressure_level(self) -> int:
        """Degrade level from queue occupancy at dispatch: occupancy below
        `queue_cap` is level 0 (full-quality search), each further
        `queue_cap` of backlog steps one level down the ladder. Always 0
        for non-degrade policies."""
        if self.cfg.policy != "degrade":
            return 0
        cap = max(self.cfg.queue_cap, 1)
        return min(len(self.cfg.degrade_levels) - 1,
                   len(self.pending) // cap)

    def take_batch(self, max_batch: int) -> list:
        """Pop up to `max_batch` oldest pending entries for dispatch."""
        return [self.pending.popleft()
                for _ in range(min(max_batch, len(self.pending)))]

    def per_tenant_rows(self) -> dict:
        """{tenant: {offered, admitted, shed}} for every tenant that saw
        traffic — the admission half of the per-tenant report."""
        return {t: {"offered": o, "admitted": self.t_admitted[t],
                    "shed": self.t_shed[t]}
                for t, o in sorted(self.t_offered.items())}
