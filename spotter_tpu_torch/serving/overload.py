"""Adaptive overload control: AIMD admission + brownout degradation ladder
(copy of spotter_tpu.serving.overload, less the fleet edge's limiter).

- `AdaptiveLimiter`: an AIMD concurrency limiter. The control signal is
  queue_wait p90 (submit -> batch dispatch) against
  `SPOTTER_TPU_ADMIT_TARGET_MS`. Under target the limit grows additively
  (`SPOTTER_TPU_ADMIT_INCREASE` per control interval); over target it
  shrinks multiplicatively (`SPOTTER_TPU_ADMIT_DECREASE`), clamped to
  [`SPOTTER_TPU_ADMIT_FLOOR`, `SPOTTER_TPU_ADMIT_CEILING`]. Admission is
  class-aware: when the limit is hit, bulk sheds strictly before slo — a
  new slo request first revokes the newest queued bulk admission, and if no
  bulk is revocable it rides a bounded soft overage while any bulk still
  holds a slot. With the tenancy plane attached (serving/tenancy.py) the
  revocation victim is the top-occupancy tenant's newest queued bulk. The
  tier is opt-in: with `SPOTTER_TPU_ADMIT_TARGET_MS`
  unset/0, `from_env()` returns None and the static queue-depth check is the
  only gate.

- `BrownoutController`: a monotonic degradation ladder armed by sustained
  saturation (the limiter pinned at its floor, or queue_wait p90 above
  `SPOTTER_TPU_BROWNOUT_SLACK_MS`) for `SPOTTER_TPU_BROWNOUT_ARM_S`. Rungs,
  entered one at a time: 1 stale (the result cache serves expired entries,
  marked `degraded: ["stale"]`), 2 bucket_cap (the batcher's dispatch
  bucket drops one rung), 3 threshold (the detection threshold rises by
  `SPOTTER_TPU_BROWNOUT_THRESHOLD_BOOST`), 4 bulk_503 (bulk traffic shed
  with 503; with the tenancy plane attached, only over-share tenants'). Each rung is exited one at a
  time after saturation stays clear for `SPOTTER_TPU_BROWNOUT_DISARM_S`.

Each rung transition pins a synthetic trace in the flight recorder, so
`/debug/traces` answers when this replica browned out and how deep. The
fault seam `overload_spike=N` (testing/faults.py) makes the limiter's next
N control ticks see a queue-wait p90 of 10x its target.

Everything here is engine-free and clock-injectable.
"""

import logging
import threading
import time
from typing import Callable, Optional

from spotter_tpu_torch import obs
from spotter_tpu_torch.serving.resilience import (
    AdmissionError,
    _env_float,
    _env_int,
)
from spotter_tpu_torch.testing import faults

logger = logging.getLogger(__name__)

# Request classes (the X-Request-Class header's values).
SLO = "slo"
BULK = "bulk"

ADMIT_TARGET_ENV = "SPOTTER_TPU_ADMIT_TARGET_MS"
ADMIT_FLOOR_ENV = "SPOTTER_TPU_ADMIT_FLOOR"
ADMIT_CEILING_ENV = "SPOTTER_TPU_ADMIT_CEILING"
ADMIT_INCREASE_ENV = "SPOTTER_TPU_ADMIT_INCREASE"
ADMIT_DECREASE_ENV = "SPOTTER_TPU_ADMIT_DECREASE"
ADMIT_INTERVAL_ENV = "SPOTTER_TPU_ADMIT_INTERVAL_S"

BROWNOUT_ARM_ENV = "SPOTTER_TPU_BROWNOUT_ARM_S"
BROWNOUT_DISARM_ENV = "SPOTTER_TPU_BROWNOUT_DISARM_S"
BROWNOUT_SLACK_ENV = "SPOTTER_TPU_BROWNOUT_SLACK_MS"
BROWNOUT_MAX_RUNG_ENV = "SPOTTER_TPU_BROWNOUT_MAX_RUNG"
BROWNOUT_THRESHOLD_BOOST_ENV = "SPOTTER_TPU_BROWNOUT_THRESHOLD_BOOST"

DEFAULT_ADMIT_FLOOR = 4
DEFAULT_ADMIT_CEILING = 256
DEFAULT_ADMIT_INCREASE = 2.0
DEFAULT_ADMIT_DECREASE = 0.7
DEFAULT_ADMIT_INTERVAL_S = 0.25
DEFAULT_BROWNOUT_ARM_S = 2.0
DEFAULT_BROWNOUT_THRESHOLD_BOOST = 0.15
# saturation bar default: 8x the limiter's queue-wait target — "p90 so far
# over target that the deadline slack is gone" without needing a deadline
DEFAULT_SLACK_FACTOR = 8.0

# brownout rungs, in escalation order (monotonic ladder)
RUNG_NONE = 0
RUNG_STALE = 1
RUNG_BUCKET_CAP = 2
RUNG_THRESHOLD = 3
RUNG_BULK_503 = 4
MAX_RUNG = RUNG_BULK_503

RUNG_NAMES = {
    RUNG_NONE: "ok",
    RUNG_STALE: "stale",
    RUNG_BUCKET_CAP: "bucket_cap",
    RUNG_THRESHOLD: "threshold",
    RUNG_BULK_503: "bulk_503",
}


class AdmitLimitError(AdmissionError):
    """The adaptive concurrency limit is hit — shed with 429 (retry)."""

    status = 429


class BrownoutShedError(AdmissionError):
    """The deepest brownout rung: bulk traffic is shed with 503 while slo
    keeps serving. Clients should back off, not hot-retry."""

    status = 503


class Admission:
    """One admitted slot. `release()` is idempotent (future done-callbacks
    and the limiter's own revocation path may both call it); a bulk
    admission may carry a revoke callback so a later slo arrival can
    reclaim the slot while the work is still queued."""

    __slots__ = ("cls", "tenant", "_limiter", "_revoke_cb", "_released", "_revocable")

    def __init__(self, limiter: "AdaptiveLimiter", cls: str, tenant: Optional[str] = None) -> None:
        self.cls = cls
        # the tenant's identity lets revocation pick the top-occupancy
        # tenant's bulk first; None when tenancy is off
        self.tenant = tenant
        self._limiter = limiter
        self._revoke_cb: Optional[Callable[[], None]] = None
        self._released = False
        self._revocable = False

    def attach_revoke(self, cb: Callable[[], None]) -> None:
        """Make this (bulk) admission revocable: `cb` fails the queued work
        when a slo arrival reclaims the slot."""
        self._revoke_cb = cb
        self._limiter._make_revocable(self)

    def make_unrevocable(self) -> None:
        """Called when the queued work is dispatched: failing it now would
        waste engine work, so it leaves the revocation stack."""
        self._limiter._make_unrevocable(self)

    def release(self) -> None:
        self._limiter._release(self)


class AdaptiveLimiter:
    """AIMD concurrency limiter over a queue-wait (or edge-latency) signal.

    Thread-safe (an RLock around the counters: admissions happen on the
    event loop, observations may arrive from batch tasks, and tests poke
    it from anywhere); the clock is injectable so the state machine is
    unit-testable without sleeping.
    """

    def __init__(
        self,
        target_ms: float,
        floor: int = DEFAULT_ADMIT_FLOOR,
        ceiling: int = DEFAULT_ADMIT_CEILING,
        increase: float = DEFAULT_ADMIT_INCREASE,
        decrease: float = DEFAULT_ADMIT_DECREASE,
        interval_s: float = DEFAULT_ADMIT_INTERVAL_S,
        clock=time.monotonic,
        metrics=None,
    ) -> None:
        # the tenant isolation plane (`MicroBatcher.attach_tenancy`): when
        # attached, revocation prefers the top-occupancy tenant's bulk; None
        # keeps revocation as it was
        self.tenancy = None
        if target_ms <= 0:
            raise ValueError("target_ms must be > 0 (unset disables the tier)")
        self.target_ms = target_ms
        self.floor = max(1, int(floor))
        self.ceiling = max(self.floor, int(ceiling))
        self.increase = max(0.0, increase)
        self.decrease = min(max(decrease, 0.05), 1.0)
        self.interval_s = max(0.01, interval_s)
        self._clock = clock
        self.metrics = metrics
        self._lock = threading.RLock()
        # start at the ceiling (optimistic): the first congested interval
        # cuts multiplicatively, which converges in a few intervals, while
        # starting low would throttle a healthy service for no reason
        self._limit = float(self.ceiling)
        self._in_flight = 0
        self._bulk_in_flight = 0
        # newest-last stack of revocable (queued, bulk) admissions
        self._revocable: list[Admission] = []
        self._samples: list[float] = []
        self._last_update = self._clock()
        self.last_p90_ms = 0.0
        self.decreases_total = 0
        self.increases_total = 0
        self.revoked_total = 0
        self.sheds_total = {SLO: 0, BULK: 0}

    @classmethod
    def from_env(
        cls, metrics=None, target_env: str = ADMIT_TARGET_ENV
    ) -> Optional["AdaptiveLimiter"]:
        """An armed limiter, or None when the tier is off (`target_env`
        unset or <= 0) — None means every caller takes the exact static
        queue-depth path, bit-identical to a pre-overload-control build."""
        target_ms = _env_float(target_env, 0.0)
        if target_ms <= 0:
            return None
        return cls(
            target_ms=target_ms,
            floor=_env_int(ADMIT_FLOOR_ENV, DEFAULT_ADMIT_FLOOR),
            ceiling=_env_int(ADMIT_CEILING_ENV, DEFAULT_ADMIT_CEILING),
            increase=_env_float(ADMIT_INCREASE_ENV, DEFAULT_ADMIT_INCREASE),
            decrease=_env_float(ADMIT_DECREASE_ENV, DEFAULT_ADMIT_DECREASE),
            interval_s=_env_float(ADMIT_INTERVAL_ENV, DEFAULT_ADMIT_INTERVAL_S),
            metrics=metrics,
        )

    # -- signal --

    @property
    def limit(self) -> int:
        return int(self._limit)

    @property
    def in_flight(self) -> int:
        return self._in_flight

    def pinned_at_floor(self) -> bool:
        """True while AIMD has cut the limit all the way to its floor — the
        'admission control alone cannot shield the engine' signal that arms
        the brownout ladder."""
        with self._lock:
            return self._limit <= self.floor

    def observe(self, wait_ms: float) -> None:
        """Feed one queue-wait (or edge-latency) sample; runs the AIMD
        update when a control interval has elapsed."""
        with self._lock:
            self._samples.append(wait_ms)
            self._maybe_update(self._clock())

    def tick(self) -> None:
        """Idle-path control tick (no sample): lets the limit climb back
        toward the ceiling after a storm even when no traffic is flowing —
        without it a floor-pinned limiter would stay 'saturated' forever
        and the brownout ladder could never disarm."""
        with self._lock:
            self._maybe_update(self._clock())

    def _maybe_update(self, now: float) -> None:
        # caller holds the lock
        if now - self._last_update < self.interval_s:
            return
        self._last_update = now
        samples, self._samples = self._samples, []
        if faults.take_overload_spike():
            # injected overload: this control tick sees a synthetic
            # far-over-target p90, the deterministic way to drive the AIMD
            # cut and the brownout arm without real queue pressure
            p90 = self.target_ms * 10.0
        elif samples:
            samples.sort()
            p90 = samples[min(int(0.9 * len(samples)), len(samples) - 1)]
        else:
            # no traffic this interval: no queueing is happening, so probe
            # upward (classic AIMD additive recovery) and let the
            # saturation signal decay
            self.last_p90_ms = 0.0
            self._limit = min(float(self.ceiling), self._limit + self.increase)
            self._publish()
            return
        self.last_p90_ms = p90
        if p90 > self.target_ms:
            self._limit = max(float(self.floor), self._limit * self.decrease)
            self.decreases_total += 1
        else:
            self._limit = min(float(self.ceiling), self._limit + self.increase)
            self.increases_total += 1
        self._publish()

    def _publish(self) -> None:
        # caller holds the lock
        if self.metrics is not None:
            self.metrics.set_admit_state(self.limit, self._in_flight)

    # -- admission --

    def try_admit(self, cls: str = SLO, tenant: Optional[str] = None) -> Optional[Admission]:
        """One admission attempt. Returns a slot, or None (shed).

        Class order is structural: when the limit is hit, a bulk arrival
        always sheds; an slo arrival first revokes the newest queued bulk
        admission, and failing that rides a soft overage while ANY bulk
        still holds a slot (each overage slot is backed by at least one
        bulk slot, so the true engine pressure stays <= limit once bulk
        drains) — slo is shed only when the limit is hit by slo alone.
        With the tenancy plane attached the revocation victim is the
        top-occupancy tenant's newest queued bulk.
        """
        if cls not in (SLO, BULK):
            cls = SLO
        with self._lock:
            self._maybe_update(self._clock())
            if self._in_flight < self.limit:
                return self._admit(cls, tenant)
            if cls == BULK:
                return self._shed(cls)
            victim = self._pop_revocable()
            if victim is not None:
                self._revoke(victim)
                return self._admit(cls, tenant)
            if self._bulk_in_flight > 0:
                # bounded soft overage (see above)
                return self._admit(cls, tenant)
            return self._shed(cls)

    def _admit(self, cls: str, tenant: Optional[str] = None) -> Admission:
        # caller holds the lock
        self._in_flight += 1
        if cls == BULK:
            self._bulk_in_flight += 1
        return Admission(self, cls, tenant)

    def _shed(self, cls: str) -> None:
        # caller holds the lock
        self.sheds_total[cls] += 1
        if self.metrics is not None:
            self.metrics.record_admit_shed(cls)
        return None

    def _pop_revocable(self) -> Optional[Admission]:
        # caller holds the lock; newest first (LIFO-ish: the freshest bulk
        # work has waited least and wasted least); with the tenancy plane
        # attached, the top-occupancy tenant's newest first, falling back to
        # plain newest-first when that tenant holds none
        self._revocable = [a for a in self._revocable if not a._released]
        if not self._revocable:
            return None
        if self.tenancy is not None:
            top = self.tenancy.top_occupancy_tenant()
            if top is not None:
                for adm in reversed(self._revocable):
                    if adm.tenant == top:
                        self._revocable.remove(adm)
                        return adm
        return self._revocable.pop()

    def _revoke(self, adm: Admission) -> None:
        # caller holds the lock; free the slot NOW (the victim's own
        # done-callback release becomes an idempotent no-op later)
        self.revoked_total += 1
        self.sheds_total[BULK] += 1
        if self.metrics is not None:
            self.metrics.record_admit_shed(BULK)
        self._do_release(adm)
        cb = adm._revoke_cb
        if cb is not None:
            try:
                cb()
            except Exception:
                logger.exception("bulk admission revoke callback failed")

    def _make_revocable(self, adm: Admission) -> None:
        with self._lock:
            if not adm._released and not adm._revocable:
                adm._revocable = True
                self._revocable.append(adm)

    def _make_unrevocable(self, adm: Admission) -> None:
        with self._lock:
            if adm._revocable:
                adm._revocable = False
                try:
                    self._revocable.remove(adm)
                except ValueError:
                    pass

    def _release(self, adm: Admission) -> None:
        with self._lock:
            self._do_release(adm)

    def _do_release(self, adm: Admission) -> None:
        # caller holds the lock
        if adm._released:
            return
        adm._released = True
        if adm._revocable:
            adm._revocable = False
            try:
                self._revocable.remove(adm)
            except ValueError:
                pass
        self._in_flight = max(0, self._in_flight - 1)
        if adm.cls == BULK:
            self._bulk_in_flight = max(0, self._bulk_in_flight - 1)

    # -- introspection --

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "limit": self.limit,
                "floor": self.floor,
                "ceiling": self.ceiling,
                "in_flight": self._in_flight,
                "bulk_in_flight": self._bulk_in_flight,
                "last_p90_ms": round(self.last_p90_ms, 3),
                "target_ms": self.target_ms,
                "pinned_at_floor": self._limit <= self.floor,
                "increases_total": self.increases_total,
                "decreases_total": self.decreases_total,
                "revoked_total": self.revoked_total,
                "sheds_total": dict(self.sheds_total),
            }


def saturation_signals(
    limiter: AdaptiveLimiter, slack_ms: float, metrics=None
) -> tuple[Callable[[], bool], Callable[[], bool]]:
    """The default brownout signal pair `(saturated, hold)`.

    `saturated` ESCALATES the ladder: the limiter pinned at its floor, or
    queue_wait p90 over the slack bar — hard evidence admission control
    alone cannot shield the engine. `hold` only BLOCKS de-escalation:
    requests are still actively being shed. The asymmetry matters twice
    over — mere sustained shedding must not walk a healthy limiter's
    system to bulk-503 (the limiter shedding bulk at 1.5x capacity is
    working as designed, not browning out), but at the deepest rung the
    measured queue goes quiet precisely BECAUSE the flood is being 503'd,
    and without the hold term the ladder would read that calm as recovery,
    step down, re-admit the flood, and cycle across the top rung boundary.
    """
    last_sheds = [metrics.admit_sheds_count() if metrics is not None else 0]

    def saturated() -> bool:
        return limiter.pinned_at_floor() or limiter.last_p90_ms > slack_ms

    def hold() -> bool:
        if metrics is None:
            return False
        total = metrics.admit_sheds_count()
        shedding = total > last_sheds[0]
        last_sheds[0] = total
        return shedding

    return saturated, hold


class BrownoutController:
    """Monotonic degradation ladder with enter/exit hysteresis.

    `saturated()` is the armed signal (default from `from_env`: limiter
    pinned at floor OR queue_wait p90 over the slack bar). The rung
    escalates one step after the signal holds continuously for `arm_s`,
    and de-escalates one step after it stays continuously clear for
    `disarm_s` (default 2x arm_s) — a signal oscillating faster than
    either window moves nothing, which is the no-flap contract the unit
    tests pin. `evaluate()` is a lazy clock-driven tick: call it from
    admission paths, control loops, and health checks; it is cheap and
    idempotent within a tick.
    """

    def __init__(
        self,
        saturated: Callable[[], bool],
        arm_s: float = DEFAULT_BROWNOUT_ARM_S,
        disarm_s: Optional[float] = None,
        max_rung: int = MAX_RUNG,
        threshold_boost: float = DEFAULT_BROWNOUT_THRESHOLD_BOOST,
        clock=time.monotonic,
        metrics=None,
        recorder=None,
        hold: Optional[Callable[[], bool]] = None,
    ) -> None:
        # the tenant isolation plane (`MicroBatcher.attach_tenancy`): when
        # attached, the bulk_503 rung sheds only over-share tenants; None
        # keeps the rung class-wide
        self.tenancy = None
        self.saturated = saturated
        # `hold` (optional): blocks DE-escalation without driving
        # escalation — see saturation_signals for why the asymmetry exists
        self.hold = hold
        self.arm_s = max(0.01, arm_s)
        self.disarm_s = self.arm_s * 2.0 if disarm_s is None else max(0.01, disarm_s)
        self.max_rung = min(max(0, int(max_rung)), MAX_RUNG)
        self.threshold_boost = max(0.0, threshold_boost)
        self._clock = clock
        self.metrics = metrics
        self._recorder = recorder
        self._lock = threading.RLock()
        self._rung = RUNG_NONE
        self._sat_since: Optional[float] = None
        self._clear_since: Optional[float] = None
        self._last_change = self._clock()
        self.transitions_total = 0

    @classmethod
    def from_env(
        cls, limiter: Optional[AdaptiveLimiter], metrics=None
    ) -> Optional["BrownoutController"]:
        """Armed together with the limiter: one knob
        (`SPOTTER_TPU_ADMIT_TARGET_MS`) opts the whole overload-control
        tier in; `SPOTTER_TPU_BROWNOUT_MAX_RUNG=0` keeps the limiter but
        disables the ladder."""
        if limiter is None:
            return None
        max_rung = _env_int(BROWNOUT_MAX_RUNG_ENV, MAX_RUNG)
        if max_rung <= 0:
            return None
        slack_ms = _env_float(
            BROWNOUT_SLACK_ENV, limiter.target_ms * DEFAULT_SLACK_FACTOR
        )
        saturated, hold = saturation_signals(limiter, slack_ms, metrics=metrics)
        return cls(
            saturated,
            arm_s=_env_float(BROWNOUT_ARM_ENV, DEFAULT_BROWNOUT_ARM_S),
            disarm_s=_env_float(BROWNOUT_DISARM_ENV, 0.0) or None,
            max_rung=max_rung,
            threshold_boost=_env_float(
                BROWNOUT_THRESHOLD_BOOST_ENV, DEFAULT_BROWNOUT_THRESHOLD_BOOST
            ),
            metrics=metrics,
            hold=hold,
        )

    # -- state machine --

    @property
    def rung(self) -> int:
        return self._rung

    def evaluate(self) -> int:
        """Advance the ladder state machine against the clock; returns the
        (possibly new) rung."""
        with self._lock:
            now = self._clock()
            if self.saturated():
                self._clear_since = None
                if self._sat_since is None:
                    self._sat_since = now
                if (
                    self._rung < self.max_rung
                    and now - self._sat_since >= self.arm_s
                    and now - self._last_change >= self.arm_s
                ):
                    self._set_rung(self._rung + 1, now)
            elif self._rung > RUNG_NONE and self.hold is not None and self.hold():
                # still shedding: not saturated enough to escalate, not
                # recovered enough to give a concession back — the clear
                # window restarts
                self._sat_since = None
                self._clear_since = None
            else:
                self._sat_since = None
                if self._clear_since is None:
                    self._clear_since = now
                if (
                    self._rung > RUNG_NONE
                    and now - self._clear_since >= self.disarm_s
                    and now - self._last_change >= self.disarm_s
                ):
                    self._set_rung(self._rung - 1, now)
            return self._rung

    def _set_rung(self, new_rung: int, now: float) -> None:
        # caller holds the lock
        old = self._rung
        self._rung = new_rung
        self._last_change = now
        self.transitions_total += 1
        if self.metrics is not None:
            self.metrics.set_brownout_rung(new_rung)
            self.metrics.record_brownout_transition()
        direction = "entered" if new_rung > old else "exited"
        logger.warning(
            "brownout rung %d (%s) %s (was %d/%s)",
            new_rung, RUNG_NAMES.get(new_rung, "?"), direction,
            old, RUNG_NAMES.get(old, "?"),
        )
        self._pin_transition_trace(old, new_rung)

    def _pin_transition_trace(self, old: int, new: int) -> None:
        """Pin a synthetic trace in the flight recorder so `/debug/traces`
        answers when this replica browned out, and how deep. Best effort:
        recording must never fail a transition."""
        try:
            recorder = self._recorder or obs.get_recorder()
            if not recorder.enabled:
                return
            request_id = f"brownout-{self.transitions_total}-rung{old}-to-rung{new}"
            trace = obs.Trace(obs.trace_id_for_request(request_id), request_id)
            trace.set_error(
                "brownout",
                f"rung {old} ({RUNG_NAMES.get(old)}) -> {new} ({RUNG_NAMES.get(new)})",
            )
            recorder.record(trace)
        except Exception:
            logger.exception("pinning brownout transition trace failed")

    # -- rung effects (queried by batcher / detector / cache) --

    def stale_ok(self) -> bool:
        """Rung >= 1: expired result-cache entries become acceptable."""
        return self._rung >= RUNG_STALE

    def bucket_cap_active(self) -> bool:
        """Rung >= 2: the batcher caps its dispatch bucket one rung down."""
        return self._rung >= RUNG_BUCKET_CAP

    def threshold_boost_value(self) -> float:
        """Rung >= 3: how much to raise the effective detection threshold."""
        return self.threshold_boost if self._rung >= RUNG_THRESHOLD else 0.0

    def shed_bulk(self, tenant: Optional[str] = None) -> bool:
        """Rung >= 4: bulk traffic is shed with 503 at admission. With the
        tenancy plane attached and a tenant known, only a tenant holding
        more than its weight-fair share of the current occupancy is shed;
        otherwise the rung is class-wide."""
        if self._rung < RUNG_BULK_503:
            return False
        if self.tenancy is not None and tenant is not None:
            return self.tenancy.over_share(tenant)
        return True

    def markers(self) -> list[str]:
        """Active degradation markers for the response-level `degraded`
        field (the `stale` marker is added per response by the detector,
        only when a stale entry was served)."""
        out = []
        if self._rung >= RUNG_BUCKET_CAP:
            out.append("bucket_cap")
        if self._rung >= RUNG_THRESHOLD:
            out.append("threshold")
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "rung": self._rung,
                "rung_name": RUNG_NAMES.get(self._rung, "?"),
                "max_rung": self.max_rung,
                "arm_s": self.arm_s,
                "disarm_s": self.disarm_s,
                "transitions_total": self.transitions_total,
            }


def build_overload_control(
    metrics=None, target_env: str = ADMIT_TARGET_ENV
) -> tuple[Optional[AdaptiveLimiter], Optional[BrownoutController]]:
    """The serving wiring: (limiter, brownout) from the env, both None when
    the tier is off."""
    limiter = AdaptiveLimiter.from_env(metrics=metrics, target_env=target_env)
    brownout = BrownoutController.from_env(limiter, metrics=metrics)
    return limiter, brownout
