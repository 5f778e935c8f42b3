"""Tenant identity and isolation plane of the replica (the port's copy of
spotter_tpu.serving.tenancy).

One flooding or retry-storming client must not consume the batcher queue,
the AIMD admission limit or the SLO budget every other client shares.
Four pieces, stdlib-only:

- **Identity** (`TenantPlane.resolve`): the `X-Spotter-Tenant` header
  names a tenant but is never trusted bare. It is honored only when (a)
  the request carries the edge-attestation token (`X-Spotter-Edge-Token`
  matching `SPOTTER_TPU_TENANT_EDGE_SECRET`; edges stamp it with
  `stamp()`), (b) it matches the tenant the API-key map resolves
  (`SPOTTER_TPU_TENANT_KEYS`, a path to a JSON file of api-key -> tenant,
  checked against `X-API-Key`), or (c) `SPOTTER_TPU_TENANT_TRUST_HEADER=1`
  opts the deployment in. Otherwise identity is the API key's tenant, else
  `"anon"`: every unauthenticated client shares one bucket, so inventing
  ids gains nothing.
- **Token-bucket quotas** (`TokenBucket`, `TenantPlane.try_admit`): a rate
  and burst per tenant from `SPOTTER_TPU_TENANT_CONFIG` (a path to, or
  inline, JSON; below), `SPOTTER_TPU_TENANT_RPS_DEFAULT` the fallback rate.
  An over-quota request sheds 429 with a tenant-scoped jittered Retry-After
  before any fetch or decode. A per-tenant inflight cap bounds slow-loris
  occupancy the rate bucket cannot see.
- **Fair scheduling** (`TenantPlane.drr_order`): deficit-weighted
  round-robin across the tenants present, for the scheduler's within-class
  order. With one distinct tenant (or the plane off) the input list is
  returned unchanged, so FIFO stays bit-identical.
- **Per-tenant accounting** (`record_outcome`, `metrics_view`, `snapshot`):
  admits, sheds, occupancy and an `SloBurn` per tenant. `/metrics` shows
  the top K tenants by admits (`SPOTTER_TPU_TENANT_TOP_K`, default 8) plus
  an `other` row; `/debug/tenants` (admin-gated) serves the full table.

Config format (`SPOTTER_TPU_TENANT_CONFIG`):

    {"default": {"rps": 50, "burst": 100, "weight": 1, "max_inflight": 0},
     "tenants": {"acme": {"rps": 200, "burst": 400, "weight": 4},
                 "hobby": {"rps": 5}}}

Unset fields inherit the default block; an absent default block inherits
`SPOTTER_TPU_TENANT_RPS_DEFAULT` (rate; burst = 2x rate), weight 1 and no
inflight cap. `rps` 0 (or negative) is unlimited for that tenant.

`from_env()` returns None unless one of `SPOTTER_TPU_TENANT_KEYS`,
`SPOTTER_TPU_TENANT_CONFIG` or `SPOTTER_TPU_TENANT_RPS_DEFAULT` is set: the
plane is absent, not idle, in an unconfigured deployment, and serving is
bit-identical to a replica without it.
"""

import hmac
import json
import logging
import os
import random
import threading
import time
from collections import deque
from typing import Callable, Optional

from spotter_tpu_torch.obs.perf import SloBurn
from spotter_tpu_torch.serving.resilience import AdmissionError, jittered_retry_after

logger = logging.getLogger(__name__)

TENANT_HEADER = "X-Spotter-Tenant"
API_KEY_HEADER = "X-API-Key"
# edge attestation: carries the shared secret that makes a
# forwarded X-Spotter-Tenant trustworthy on the next hop
EDGE_TOKEN_HEADER = "X-Spotter-Edge-Token"
ANON = "anon"

TENANT_KEYS_ENV = "SPOTTER_TPU_TENANT_KEYS"
TENANT_CONFIG_ENV = "SPOTTER_TPU_TENANT_CONFIG"
TENANT_RPS_DEFAULT_ENV = "SPOTTER_TPU_TENANT_RPS_DEFAULT"
TENANT_TOP_K_ENV = "SPOTTER_TPU_TENANT_TOP_K"
TENANT_EDGE_SECRET_ENV = "SPOTTER_TPU_TENANT_EDGE_SECRET"
TENANT_TRUST_HEADER_ENV = "SPOTTER_TPU_TENANT_TRUST_HEADER"

DEFAULT_TOP_K = 8
# burst defaults to 2x the sustained rate: one second of doubled arrival
# absorbs without a shed, which is what "bursty but in quota" means
DEFAULT_BURST_FACTOR = 2.0
# hard cap on tracked per-tenant state: a flood inventing fresh tenant ids
# must not grow memory without bound — least-recently-admitted evicted
MAX_TRACKED_TENANTS = 1024
# eviction backstop: a tenant whose inflight slot has not been
# touched for this long is a leak (every handler releases in a finally,
# so a live request can't look this stale) — reclaimable under pressure
INFLIGHT_STALE_S = 600.0

SHED_RATE = "rate"
SHED_INFLIGHT = "inflight"


class TenantQuotaError(AdmissionError):
    """Tenant over its rate quota or inflight cap — shed with 429 before
    any fetch/decode work; the hint is tenant-scoped (this tenant's own
    bucket refill time), jittered like every other Retry-After."""

    status = 429

    def __init__(
        self, tenant: str, kind: str, retry_after_s: float = 1.0
    ) -> None:
        what = (
            "rate quota" if kind == SHED_RATE else "concurrent-inflight cap"
        )
        super().__init__(
            f"tenant {tenant!r} over its {what}",
            retry_after_s=retry_after_s,
        )
        self.tenant = tenant
        self.kind = kind


class TokenBucket:
    """Classic token bucket: `burst` capacity, `rate` tokens/s refill.

    The clock is injectable so the property tests drive it
    deterministically. Invariants the tests pin: tokens never exceed
    `burst`, refill is monotone in elapsed time, and arrival at exactly
    the sustained rate never starves (every request finds its token).
    """

    __slots__ = ("rate", "burst", "tokens", "_t_last", "_clock")

    def __init__(
        self,
        rate: float,
        burst: float,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.rate = max(float(rate), 0.0)
        self.burst = max(float(burst), 1.0)
        self.tokens = self.burst  # a fresh tenant starts with full burst
        self._clock = clock
        self._t_last = clock()

    def _refill(self, now: float) -> None:
        if now > self._t_last:
            self.tokens = min(
                self.burst, self.tokens + (now - self._t_last) * self.rate
            )
        self._t_last = now

    def try_take(self, n: float = 1.0) -> bool:
        self._refill(self._clock())
        # a nanotoken of grace: arrival at EXACTLY the sustained rate
        # accumulates float representation error across refills, and the
        # quota boundary belongs to the tenant — never-starves is pinned
        if self.tokens >= n - 1e-9:
            self.tokens = max(self.tokens - n, 0.0)
            return True
        return False

    def retry_after_s(self, n: float = 1.0) -> float:
        """Seconds until `n` tokens will be available at the current fill
        — THE tenant-scoped hint (a fast bucket says retry soon, a slow
        one says back off properly)."""
        self._refill(self._clock())
        missing = n - self.tokens
        if missing <= 0.0:
            return 0.0
        if self.rate <= 0.0:
            return 1.0
        return missing / self.rate


class _TenantState:
    """Everything tracked for one active tenant."""

    __slots__ = (
        "bucket", "weight", "max_inflight", "inflight",
        "admits_total", "sheds_total", "burn", "last_seen",
    )

    def __init__(
        self,
        bucket: Optional[TokenBucket],
        weight: float,
        max_inflight: int,
    ) -> None:
        self.bucket = bucket
        self.weight = weight
        self.max_inflight = max_inflight
        self.inflight = 0
        self.admits_total = 0
        self.sheds_total = {SHED_RATE: 0, SHED_INFLIGHT: 0}
        self.burn = SloBurn()
        self.last_seen = 0.0


class _Admitted:
    """Release handle for one admitted request: decrements the tenant's
    inflight occupancy exactly once and feeds its per-tenant SLO burn.

    `good=None` releases the slot WITHOUT touching the SLO burn — the
    abandoned-request path (client disconnect mid-await, uncaught handler
    error) where no outcome was served: the leak guard must not let a
    disconnect flood poison (or credit) anyone's budget. Idempotent, so
    the handler's finally can release unconditionally and the normal
    done() path still wins with the real outcome."""

    __slots__ = ("_plane", "tenant", "_released")

    def __init__(self, plane: "TenantPlane", tenant: str) -> None:
        self._plane = plane
        self.tenant = tenant
        self._released = False

    def release(self, good: Optional[bool] = True) -> None:
        if self._released:
            return
        self._released = True
        self._plane._release(self.tenant, good)


class TenantPlane:
    """The shared isolation plane: identity, quotas, DRR state, and
    per-tenant accounting. Thread-safe — edges call from the event loop,
    the batcher's engine worker records outcomes from its thread."""

    def __init__(
        self,
        config: Optional[dict] = None,
        key_map: Optional[dict] = None,
        default_rps: float = 0.0,
        top_k: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
        edge_secret: Optional[str] = None,
        trust_header: bool = False,
    ) -> None:
        config = config or {}
        self._key_map = dict(key_map or {})
        defaults = dict(config.get("default") or {})
        tenants = config.get("tenants")
        if tenants is None:
            # flat form: the whole object (minus "default") is the map
            tenants = {
                k: v for k, v in config.items() if k != "default"
            }
        self._tenant_cfg = {
            str(k): dict(v or {}) for k, v in tenants.items()
        }
        self.default_rps = float(defaults.get("rps", default_rps) or 0.0)
        self.default_burst = float(
            defaults.get("burst", self.default_rps * DEFAULT_BURST_FACTOR)
            or 0.0
        )
        self.default_weight = max(float(defaults.get("weight", 1.0)), 1e-6)
        self.default_max_inflight = int(defaults.get("max_inflight", 0) or 0)
        self.top_k = (
            top_k
            if top_k is not None
            else _env_int(TENANT_TOP_K_ENV, DEFAULT_TOP_K)
        )
        self._clock = clock
        self._rng = rng
        self._edge_secret = edge_secret or None
        self.trust_header = bool(trust_header)
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantState] = {}
        # plane-level totals (the admit_sheds_total-style counters the
        # contract test reads without depending on label bounding)
        self.admits_total = 0
        self.sheds_total = {SHED_RATE: 0, SHED_INFLIGHT: 0}
        # spoof visibility: claimed-but-unattested tenant headers that
        # fell back to key/anon identity
        self.header_rejects_total = 0

    # ---- identity ----

    def resolve(self, headers) -> str:
        """Tenant id for a request. `headers` is any mapping with .get
        (aiohttp CIMultiDict works).

        The claimed `X-Spotter-Tenant` header is honored only when it is
        ATTESTED: the edge token matches the shared secret, the
        API-key map resolves the same tenant, or the deployment opted
        into bare-header trust. Everything else resolves through the
        API key alone, else to `anon` — one shared bucket, so a spoofer
        rotating invented ids gains neither a victim's quota nor a fresh
        burst, and cannot skew a victim's burn/occupancy accounting."""
        if headers is None:
            return ANON
        key = str(headers.get(API_KEY_HEADER, "") or "").strip()
        key_tenant = (
            str(self._key_map[key])
            if key and key in self._key_map
            else None
        )
        claimed = str(headers.get(TENANT_HEADER, "") or "").strip()
        if claimed:
            if self.trust_header:
                return claimed
            if self._edge_secret is not None:
                token = str(headers.get(EDGE_TOKEN_HEADER, "") or "")
                if token and hmac.compare_digest(token, self._edge_secret):
                    return claimed
            if key_tenant is not None and claimed == key_tenant:
                return key_tenant
            with self._lock:
                self.header_rejects_total += 1
        if key_tenant is not None:
            return key_tenant
        return ANON

    def stamp(self, headers: dict, tenant: str) -> None:
        """Stamp the RESOLVED identity onto forwarded headers (edge ->
        replica hop), plus the attestation token when a shared secret is
        configured — the next hop's plane then honors the id without
        re-deriving it from client-controlled input."""
        headers[TENANT_HEADER] = tenant
        if self._edge_secret is not None:
            headers[EDGE_TOKEN_HEADER] = self._edge_secret

    # ---- per-tenant config ----

    def _cfg(self, tenant: str, field: str, default):
        cfg = self._tenant_cfg.get(tenant)
        if cfg is not None and field in cfg and cfg[field] is not None:
            return cfg[field]
        return default

    def weight(self, tenant: str) -> float:
        return max(float(self._cfg(tenant, "weight", self.default_weight)),
                   1e-6)

    def _make_state(self, tenant: str) -> _TenantState:
        cfg = self._tenant_cfg.get(tenant) or {}
        rps = float(self._cfg(tenant, "rps", self.default_rps) or 0.0)
        if cfg.get("burst") is not None:
            burst = float(cfg["burst"] or 0.0)
        elif cfg.get("rps") is None:
            # rate fully inherited from the default block: inherit its
            # burst too (which itself defaults to 2x the default rate)
            burst = self.default_burst
        else:
            # per-tenant rate override without an explicit burst: scale
            # the burst to THIS tenant's rate, not the default block's
            burst = rps * DEFAULT_BURST_FACTOR
        bucket = (
            TokenBucket(rps, burst, clock=self._clock) if rps > 0.0 else None
        )
        max_inflight = int(
            self._cfg(tenant, "max_inflight", self.default_max_inflight) or 0
        )
        return _TenantState(bucket, self.weight(tenant), max_inflight)

    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            if len(self._tenants) >= MAX_TRACKED_TENANTS:
                # evict the least-recently-admitted UNOCCUPIED tenant so a
                # tenant-id flood can't grow this map without bound
                idle = [
                    (s.last_seen, t)
                    for t, s in self._tenants.items()
                    if s.inflight == 0
                ]
                if not idle:
                    # backstop: every tracked tenant claims an
                    # inflight slot — slots untouched past the stale
                    # horizon are leaks (handlers release in a finally,
                    # so live requests never look this old) and must not
                    # make their tenants immortal
                    horizon = self._clock() - INFLIGHT_STALE_S
                    idle = [
                        (s.last_seen, t)
                        for t, s in self._tenants.items()
                        if s.last_seen < horizon
                    ]
                if idle:
                    _, victim = min(idle)
                    del self._tenants[victim]
            st = self._make_state(tenant)
            if len(self._tenants) < MAX_TRACKED_TENANTS:
                self._tenants[tenant] = st
            # else: full AND nothing evictable (MAX tenants all holding
            # fresh inflight) — serve off transient untracked state so
            # the memory bound is HARD; accounting for this tenant is
            # degraded until pressure drops, never the map unbounded
        return st

    # ---- admission ----

    def try_admit(self, tenant: str) -> _Admitted:
        """Admit one request for `tenant` or raise TenantQuotaError (429).

        Checked BEFORE any fetch/decode work and strictly before any
        in-quota request would be shed: the inflight cap first (slow-loris
        occupancy), then the rate bucket. Success returns a release handle
        that MUST be released exactly once."""
        with self._lock:
            st = self._state(tenant)
            st.last_seen = self._clock()
            if 0 < st.max_inflight <= st.inflight:
                st.sheds_total[SHED_INFLIGHT] += 1
                self.sheds_total[SHED_INFLIGHT] += 1
                st.burn.bad()
                raise TenantQuotaError(
                    tenant,
                    SHED_INFLIGHT,
                    retry_after_s=max(
                        jittered_retry_after(1.0, rng=self._rng), 0.1
                    ),
                )
            if st.bucket is not None and not st.bucket.try_take():
                st.sheds_total[SHED_RATE] += 1
                self.sheds_total[SHED_RATE] += 1
                st.burn.bad()
                raise TenantQuotaError(
                    tenant,
                    SHED_RATE,
                    retry_after_s=max(
                        jittered_retry_after(
                            max(st.bucket.retry_after_s(), 0.05),
                            rng=self._rng,
                        ),
                        0.05,
                    ),
                )
            st.inflight += 1
            st.admits_total += 1
            self.admits_total += 1
            return _Admitted(self, tenant)

    def _release(self, tenant: str, good: Optional[bool]) -> None:
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                return
            st.inflight = max(st.inflight - 1, 0)
            if good is None:  # abandoned: no outcome served, no burn
                return
            if good:
                st.burn.good()
            else:
                st.burn.bad()

    def record_outcome(self, tenant: Optional[str], good: bool) -> None:
        """Per-tenant SLO accounting for paths that bypass try_admit
        (e.g. the batcher recording a deadline miss for an already
        admitted image)."""
        if not tenant:
            tenant = ANON
        with self._lock:
            st = self._state(tenant)
            if good:
                st.burn.good()
            else:
                st.burn.bad()

    # ---- occupancy / overload scoping ----

    def inflight(self, tenant: str) -> int:
        with self._lock:
            st = self._tenants.get(tenant)
            return st.inflight if st is not None else 0

    def top_occupancy_tenant(self) -> Optional[str]:
        """Tenant holding the most weight-normalized inflight occupancy
        right now (ties broken by name for determinism); None when idle.
        The limiter revokes THIS tenant's bulk first."""
        with self._lock:
            best = None
            best_score = 0.0
            for t, st in sorted(self._tenants.items()):
                score = st.inflight / st.weight
                if st.inflight > 0 and score > best_score:
                    best, best_score = t, score
            return best

    def over_share(self, tenant: Optional[str]) -> bool:
        """Is `tenant` holding more than its weight-fair share of current
        inflight occupancy? Brownout rung 4 browns out ONLY over-share
        tenants; in-quota tenants keep full service. Unknown/idle tenants
        are never over share."""
        if not tenant:
            return False
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None or st.inflight == 0:
                return False
            total_inflight = sum(s.inflight for s in self._tenants.values())
            if total_inflight <= st.inflight:
                return True  # alone on the server: its own backlog
            active_weight = sum(
                s.weight
                for s in self._tenants.values()
                if s.inflight > 0
            )
            fair = st.weight / active_weight if active_weight > 0 else 1.0
            return st.inflight / total_inflight > fair + 1e-9

    # ---- fair scheduling (DRR) ----

    def drr_order(self, items: list, tenant_of: Callable[[object], str]):
        """Deficit-weighted round-robin across the tenants present in
        `items`, preserving each tenant's internal order. With zero or one
        distinct tenant the INPUT LIST is returned unchanged (identity,
        not a copy) — the bit-identity opt-out the scheduler tests pin.

        Fairness is PER CALL (classic DRR: a deficit resets the moment
        its queue empties, and every queue drains within the call, so no
        credit survives to the next one). That is the window that
        matters: each plan() round is handed the whole pending backlog
        and re-interleaves it, so a tenant wronged in one round is
        re-ranked fairly from scratch in the next — nothing banks, for
        anyone."""
        tenants: list[str] = []
        queues: dict[str, deque] = {}
        for it in items:
            t = tenant_of(it) or ANON
            q = queues.get(t)
            if q is None:
                q = queues[t] = deque()
                tenants.append(t)
            q.append(it)
        if len(tenants) <= 1:
            return items
        deficit = {t: 0.0 for t in tenants}
        out: list = []
        while len(out) < len(items):
            for t in tenants:
                q = queues[t]
                if not q:
                    continue
                # quantum = weight: a weight-4 tenant drains 4 items
                # per round for a weight-1 tenant's one
                deficit[t] += self.weight(t)
                while q and deficit[t] >= 1.0:
                    deficit[t] -= 1.0
                    out.append(q.popleft())
                if not q:
                    # emptied: surrender leftover credit (no banking)
                    deficit[t] = 0.0
        return out

    # ---- observability ----

    def _tenant_row(self, st: _TenantState) -> dict:
        return {
            "inflight": st.inflight,
            "admits_total": st.admits_total,
            "sheds_rate_total": st.sheds_total[SHED_RATE],
            "sheds_inflight_total": st.sheds_total[SHED_INFLIGHT],
            "slo_burn": st.burn.burn(60.0),
            "weight": st.weight,
            "rps": st.bucket.rate if st.bucket is not None else 0.0,
            "burst": st.bucket.burst if st.bucket is not None else 0.0,
            "max_inflight": st.max_inflight,
        }

    def metrics_view(self) -> dict:
        """Bounded per-tenant numeric map for /metrics: top-K tenants by
        admits + an `other` overflow row summing the rest. The prom
        renderer labels these {tenant=..., stat=...}; K bounds the label
        cardinality however many tenant ids a flood invents."""
        with self._lock:
            ranked = sorted(
                self._tenants.items(),
                key=lambda kv: (-kv[1].admits_total, kv[0]),
            )
            view: dict[str, dict] = {}
            other = {
                "inflight": 0, "admits_total": 0,
                "sheds_rate_total": 0, "sheds_inflight_total": 0,
            }
            overflow = False
            for i, (t, st) in enumerate(ranked):
                if i < self.top_k:
                    row = self._tenant_row(st)
                    # metrics_view rows stay purely numeric (prom labels)
                    view[t] = {
                        k: round(float(v), 6) for k, v in row.items()
                    }
                else:
                    overflow = True
                    other["inflight"] += st.inflight
                    other["admits_total"] += st.admits_total
                    other["sheds_rate_total"] += st.sheds_total[SHED_RATE]
                    other["sheds_inflight_total"] += (
                        st.sheds_total[SHED_INFLIGHT]
                    )
            if overflow:
                view["other"] = {k: float(v) for k, v in other.items()}
            return view

    def snapshot(self) -> dict:
        """Full (but MAX_TRACKED_TENANTS-bounded) table for the
        admin-gated /debug/tenants view."""
        with self._lock:
            rows = {
                t: self._tenant_row(st)
                for t, st in sorted(self._tenants.items())
            }
        return {
            "tenants": rows,
            "active": sum(1 for r in rows.values() if r["inflight"] > 0),
            "tracked": len(rows),
            "admits_total": self.admits_total,
            "sheds_total": dict(self.sheds_total),
            "header_rejects_total": self.header_rejects_total,
            "trust_header": self.trust_header,
            "edge_attested": self._edge_secret is not None,
            "default_rps": self.default_rps,
            "default_weight": self.default_weight,
            "top_k": self.top_k,
        }


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def _load_key_map(raw: str) -> dict:
    """`SPOTTER_TPU_TENANT_KEYS` is a PATH to a JSON file (api-key ->
    tenant): keys are secrets and don't belong in `ps e` output."""
    try:
        with open(raw) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        logger.warning("tenant key map %r unreadable (%s); ignoring",
                       raw, exc)
        return {}
    if not isinstance(data, dict):
        logger.warning("tenant key map %r is not an object; ignoring", raw)
        return {}
    return {str(k): str(v) for k, v in data.items()}


def _load_edge_secret(raw: str) -> Optional[str]:
    """`SPOTTER_TPU_TENANT_EDGE_SECRET` is preferably a PATH to a file
    holding the shared attestation secret (secrets don't belong in
    `ps e` output); a value that names no file is used literally (the
    test/drill ergonomic case)."""
    if os.path.isfile(raw):
        try:
            with open(raw) as f:
                secret = f.read().strip()
        except OSError as exc:
            logger.warning(
                "tenant edge secret file %r unreadable (%s); ignoring",
                raw, exc,
            )
            return None
        return secret or None
    return raw


def _load_config(raw: str) -> dict:
    """`SPOTTER_TPU_TENANT_CONFIG` is a path OR inline JSON (inline wins
    the ergonomic case for tests and drills)."""
    text = raw
    if not raw.lstrip().startswith("{"):
        try:
            with open(raw) as f:
                text = f.read()
        except OSError as exc:
            logger.warning("tenant config %r unreadable (%s); ignoring",
                           raw, exc)
            return {}
    try:
        data = json.loads(text)
    except json.JSONDecodeError as exc:
        logger.warning("tenant config invalid JSON (%s); ignoring", exc)
        return {}
    return data if isinstance(data, dict) else {}


def from_env(
    clock: Callable[[], float] = time.monotonic,
) -> Optional[TenantPlane]:
    """None unless tenancy is configured — the whole plane is absent in
    an unconfigured deployment (bit-identical serving, the RAGGED/ADMIT
    opt-out discipline)."""
    keys_raw = os.environ.get(TENANT_KEYS_ENV, "").strip()
    cfg_raw = os.environ.get(TENANT_CONFIG_ENV, "").strip()
    rps_raw = os.environ.get(TENANT_RPS_DEFAULT_ENV, "").strip()
    if not keys_raw and not cfg_raw and not rps_raw:
        return None
    try:
        default_rps = float(rps_raw) if rps_raw else 0.0
    except ValueError:
        logger.warning("%s=%r is not a number; using 0 (unlimited)",
                       TENANT_RPS_DEFAULT_ENV, rps_raw)
        default_rps = 0.0
    secret_raw = os.environ.get(TENANT_EDGE_SECRET_ENV, "").strip()
    trust_raw = os.environ.get(TENANT_TRUST_HEADER_ENV, "").strip()
    plane = TenantPlane(
        config=_load_config(cfg_raw) if cfg_raw else None,
        key_map=_load_key_map(keys_raw) if keys_raw else None,
        default_rps=default_rps,
        clock=clock,
        edge_secret=_load_edge_secret(secret_raw) if secret_raw else None,
        trust_header=trust_raw not in ("", "0"),
    )
    logger.warning(
        "TENANT ISOLATION ACTIVE: default_rps=%s weight=%s top_k=%d "
        "(%d configured tenants, %d api keys; header %s)",
        plane.default_rps or "unlimited", plane.default_weight,
        plane.top_k, len(plane._tenant_cfg), len(plane._key_map),
        "TRUSTED BARE" if plane.trust_header
        else ("edge-attested" if plane._edge_secret is not None
              else "untrusted (key/anon identity)"),
    )
    return plane
