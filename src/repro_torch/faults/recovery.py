"""Recovery policy for offload chains: timeout, backoff, degradation.

When a requester's placed chain references a hop that died between
placement sweeps, the requester does not stall until the next sweep
notices — it pays a bounded price and degrades:

* each hop attempt is bounded by a **per-hop timeout** (a multiple of
  the hop's predicted latency, floored so near-zero predictions still
  get a real deadline);
* failed hops retry under **exponential backoff**, doubling from
  ``base_backoff_s`` and capped at ``max_backoff_s``, at most
  ``max_retries`` retries per hop;
* once a hop exhausts its retries the chain is abandoned and the
  requester **degrades gracefully** to a local elastic variant (the
  compressed depth/width/rank actions already in its action space) —
  the controller strips the dead fleet target and re-decides locally.

:func:`execute_chain` is a pure accounting model of that procedure —
hosts, liveness oracle and policy in, an auditable
:class:`ChainOutcome` out — so the retry arithmetic is unit-testable
without a fleet.

:func:`plan_migration` is the same idea for the paging PR's
freeze/thaw path: given the frozen requests coming off an evicted
engine and the destination's compatibility oracle, it splits them into
zero-re-prefill migrations vs re-prefill fallbacks and totals the
generated tokens the freeze blobs preserve — auditable before any
device state moves."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded-retry parameters for one offload hop.

    Worst-case added latency per dead hop is
    ``(max_retries + 1) × timeout + Σ backoff`` — finite by
    construction, which is the whole point: a lost helper costs one
    bad wake, not a wedged requester."""
    max_retries: int = 2
    base_backoff_s: float = 0.05
    backoff_factor: float = 2.0
    max_backoff_s: float = 1.0
    timeout_scale: float = 3.0     # per-hop timeout = scale × predicted
    min_timeout_s: float = 0.05

    def backoff_s(self, attempt: int) -> float:
        """Backoff after the ``attempt``-th failure (0-based), capped."""
        return min(self.base_backoff_s * self.backoff_factor ** attempt,
                   self.max_backoff_s)

    def timeout_s(self, predicted_hop_s: float) -> float:
        """Deadline for one attempt at a hop predicted to take
        ``predicted_hop_s``."""
        return max(self.timeout_scale * predicted_hop_s,
                   self.min_timeout_s)

    def worst_case_s(self, predicted_hop_s: float) -> float:
        """Upper bound on what one dead hop can cost before abandonment."""
        timeouts = (self.max_retries + 1) * self.timeout_s(predicted_hop_s)
        backoffs = sum(self.backoff_s(i) for i in range(self.max_retries))
        return timeouts + backoffs


@dataclass(frozen=True)
class ChainOutcome:
    """What executing (or failing to execute) a chain cost.

    ``penalty_s`` is the time burned on timeouts + backoff waits —
    zero on a fully-live chain; the requester's observed latency for
    the wake includes it, so telemetry sees the real cost of the
    failure."""
    ok: bool
    attempts: int                  # hop attempts made, successes included
    retries: int                   # failed attempts that were retried
    penalty_s: float
    failed_hop: Optional[str] = None


def execute_chain(hosts: Sequence[str], hop_latency_s: float,
                  alive: Callable[[str], bool],
                  policy: RetryPolicy) -> ChainOutcome:
    """Walk a placement chain hop by hop under the retry policy.

    ``hosts[0]`` is the requester itself (never attempted — local
    execution cannot time out on a link); each helper hop is attempted
    until it answers or retries are exhausted.  ``alive`` is the
    liveness oracle consulted per attempt, so a host revived between
    retries is observed."""
    attempts = retries = 0
    penalty = 0.0
    for host in hosts[1:]:
        tried = 0
        while True:
            attempts += 1
            if alive(host):
                break
            penalty += policy.timeout_s(hop_latency_s)
            if tried >= policy.max_retries:
                return ChainOutcome(False, attempts, retries, penalty,
                                    failed_hop=host)
            penalty += policy.backoff_s(tried)
            tried += 1
            retries += 1
    return ChainOutcome(True, attempts, retries, penalty)


@dataclass(frozen=True)
class MigrationOutcome:
    """What migrating an evicted engine's in-flight work will cost.

    ``migrated`` requests thaw on the destination with zero re-prefill;
    ``fallback`` requests re-admit through ordinary prefill (their
    generated suffix folds into the prompt — still zero token loss,
    but a prefill call).  ``recovered_tokens`` counts the generated
    tokens the freeze blobs carry across — the tokens a requeue-only
    recovery would have had to re-earn through re-prefill."""
    migrated: Tuple[int, ...]
    fallback: Tuple[int, ...]
    recovered_tokens: int

    @property
    def total(self) -> int:
        return len(self.migrated) + len(self.fallback)


def plan_migration(requests: Sequence,
                   can_thaw: Callable[[object], bool]) -> MigrationOutcome:
    """Split frozen requests into thaw-able migrations vs re-prefill
    fallbacks against a destination's compatibility oracle (its
    ``engine.can_thaw``).  Pure accounting — nothing moves; the fleet
    controller executes the plan it returns."""
    migrated, fallback, tokens = [], [], 0
    for r in requests:
        frozen = getattr(r, "frozen", None)
        if frozen is not None and can_thaw(frozen):
            migrated.append(r.rid)
        else:
            fallback.append(r.rid)
        tokens += len(getattr(r, "generated", ()) or ())
    return MigrationOutcome(tuple(migrated), tuple(fallback), tokens)
