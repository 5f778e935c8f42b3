"""Fault injection for the replica's serving path (the port's own copy of
spotter_tpu.testing.faults, for the seams the port has).

Tests and chaos-staging replicas inject faults at the seams where real
failures happen, without monkeypatching internals:

- the detector's fetch calls `await on_fetch(url)`: it may raise a
  connection error (`fetch_error=N`), sleep (`fetch_delay_s`), or
  substitute malformed bytes (`malformed_image=N`);
- the MicroBatcher's worker thread calls `on_engine_batch(images)` right
  before `engine.detect` (and again on every bisect-retry sub-batch): it may
  raise (`engine_error=N`), hang (`engine_hang_s`, until `plan.release` is
  set), or raise for every batch holding an image tagged by
  `poison_image()` (`poison_item=1`);
- the engine's dispatch calls `on_engine_dispatch`: `engine_oom=N` raises
  with the RESOURCE_EXHAUSTED marker the failure classifier reads as
  transient (the engine's bucket-downgrade retry);
- `slow_stage="<stage>:<ms>[;...]"` adds that latency to a named pipeline
  stage (obs.STAGES) on every pass: `trace.span`, the batcher's queue wait
  and the engine's stage windows;
- `overload_spike=N`: the adaptive limiter's next N control ticks see a
  queue-wait p90 of 10x its target (`take_overload_spike`);
- `flaky=<pct>`: that share of /detect requests answers 500,
  deterministically (Bresenham credit, no RNG);
- the output-integrity seams: `sdc=<pct>` perturbs that share of the
  engine's answers into plausible garbage (`corrupt_detections`, HTTP
  stays 200); `corrupt_weights=<n>` is consumed whole at bring-up and
  perturbs n device parameters before the `verifying` gate;
  `corrupt_compile_cache=1` is consumed once at the golden probe and
  perturbs its observed answer while the weights attest clean;
- `only_replica=<id>` scopes `flaky`, `sdc`, `slow_replica` and
  `corrupt_frame` to one replica id;
- the result cache calls `on_cache(op, key)` on every get and put:
  `cache_error=N` makes the next N raise, which the cache contains (a miss
  or a skipped fill, never a failed request);
- `slow_replica=<ms>`: the stub engine sleeps that long in its device
  window on every call (`replica_delay_s`);
- `corrupt_frame=<n>`: the next n binary-frame response bodies get one
  byte flipped after encoding (`corrupt_frame_bytes`), which the frame's
  CRCs must catch;
- the tenancy drill's load generators read `tenant_flood=<tenant>:<xQuota>`
  (`tenant_flood_spec`) and `tenant_retry_storm=<n>`
  (`tenant_retry_storm_n`): the abusive client is the fault, the serving
  path is unchanged.

Activation is explicit: the `inject(...)` context manager (tests) or
`maybe_activate_from_env()` reading `SPOTTER_TPU_FAULTS` (e.g.
`"fetch_error=2,engine_hang_s=30"`). With no plan active every hook is one
global None check. Counters arm the next N occurrences; `-1` means every
one. The JAX package's other faults (a dead shard, the result cache, the
binary wire format, the stub engine's slow replica, the fleet tier's
storms and controller faults, tenancy's load generators) have no seam in
the port yet: their keys raise (`UNPORTED_FAULTS`), after the JAX text for
an unknown key.
"""

import asyncio
import contextlib
import os
import threading
import time
from dataclasses import dataclass, field

FAULTS_ENV = "SPOTTER_TPU_FAULTS"

MALFORMED_BYTES = b"\x00\x01not-an-image\xff"

# Attribute set on a PIL image by `poison_image()`; the engine-batch hook
# raises whenever a tagged image is co-batched (poison_item plans only).
POISON_ATTR = "_spotter_tpu_poison"

# the JAX package's fault names, in its order
JAX_FAULTS = (
    "fetch_error", "fetch_delay_s", "malformed_image", "engine_error", "engine_hang_s",
    "poison_item", "engine_oom", "shard_dead", "cache_error", "preempt_storm",
    "overload_spike", "slow_stage", "slow_replica", "flaky", "corrupt_frame",
    "only_replica", "controller_crash", "journal_corrupt", "sdc", "corrupt_weights",
    "corrupt_compile_cache", "tenant_flood", "tenant_retry_storm",
)
# the faults whose seam lies in a plane the port does not have yet, and
# that plane's ROADMAP item
UNPORTED_FAULTS = {
    "shard_dead": "multi-GPU serving (ROADMAP Queue 1 item 10)",
    "preempt_storm": "the fleet tier (ROADMAP Queue 1 item 12)",
    "controller_crash": "the fleet tier (ROADMAP Queue 1 item 12)",
    "journal_corrupt": "the fleet tier (ROADMAP Queue 1 item 12)",
}


@dataclass
class FaultPlan:
    fetch_error: int = 0
    fetch_delay_s: float = 0.0
    malformed_image: int = 0
    engine_error: int = 0
    engine_hang_s: float = 0.0
    # poison tagging on/off, and armed device-OOM count
    poison_item: int = 0
    engine_oom: int = 0
    # armed ResultCache get/put failures (contained by the cache)
    cache_error: int = 0
    # the adaptive limiter's next N control ticks see a synthetic
    # far-over-target queue-wait p90 (consumed one per control interval)
    overload_spike: int = 0
    # "<stage>:<ms>" latency injected into the named pipeline stage on every
    # pass while the plan is active; several stages: ";"-separated pairs
    slow_stage: str = ""
    # ms of slowdown in every stub-engine call (the gray signature), percent
    # of /detect requests answering 500 (deterministic), and armed frame
    # corruptions (the next N binary-frame bodies get a byte flipped)
    slow_replica: float = 0.0
    flaky: int = 0
    corrupt_frame: int = 0
    # scope the per-replica faults to one replica id; empty = every replica
    only_replica: str = ""
    # percent of engine answers perturbed into plausible garbage, number of
    # device params corrupted at bring-up, and a one-shot miscompiled-program
    # arm at the golden probe
    sdc: int = 0
    corrupt_weights: int = 0
    corrupt_compile_cache: int = 0
    # "<tenant>:<xQuota>" (the named tenant floods at that multiple of its
    # quota) and an abusive client's immediate re-sends per shed: both read
    # by drill load generators
    tenant_flood: str = ""
    tenant_retry_storm: int = 0
    # set() to un-wedge hanging engine calls early (tests)
    release: threading.Event = field(default_factory=threading.Event)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _flaky_credit: int = 0
    _sdc_credit: int = 0

    def _consume(self, attr: str) -> bool:
        with self._lock:
            n = getattr(self, attr)
            if n == 0:
                return False
            if n > 0:
                setattr(self, attr, n - 1)
            return True


_active: FaultPlan | None = None


def active() -> FaultPlan | None:
    return _active


@contextlib.contextmanager
def inject(**kwargs):
    """Activate a fault plan for the enclosed block (re-entrant: restores
    whatever plan was active before)."""
    global _active
    prev = _active
    plan = FaultPlan(**kwargs)
    _active = plan
    try:
        yield plan
    finally:
        _active = prev


def parse_spec(spec: str) -> dict:
    """A SPOTTER_TPU_FAULTS spec as FaultPlan keyword arguments. Entries are
    read in order with the JAX package's texts (an unknown fault, a bad
    value); then a fault whose seam the port does not have raises."""
    kwargs: dict = {}
    unported = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, _, value = part.partition("=")
        key = key.strip()
        if key not in JAX_FAULTS:
            raise ValueError(f"unknown {FAULTS_ENV} fault {key!r}")
        if key in UNPORTED_FAULTS:
            unported.append(key)
        elif key == "slow_stage":
            kwargs[key] = value.strip()
            _parse_slow_stage(kwargs[key])  # fail loudly at activation
        elif key == "tenant_flood":
            kwargs[key] = value.strip()
            _parse_tenant_flood(kwargs[key])  # fail loudly at activation
        elif key == "only_replica":
            kwargs[key] = value.strip()
        else:
            try:
                duration = key.endswith("_s") or key == "slow_replica"
                kwargs[key] = float(value) if duration else int(value)
            except ValueError:
                raise ValueError(f"bad {FAULTS_ENV} entry {part!r}") from None
    if unported:
        key = unported[0]
        raise ValueError(
            f"{FAULTS_ENV} fault {key!r}: its seam, {UNPORTED_FAULTS[key]}, is not "
            f"ported; unset it to serve without it"
        )
    return kwargs


def maybe_activate_from_env() -> FaultPlan | None:
    """Arm a process-wide plan from SPOTTER_TPU_FAULTS (chaos staging only:
    the standalone server calls this at startup and logs loudly)."""
    global _active
    spec = os.environ.get(FAULTS_ENV, "").strip()
    if not spec:
        return None
    _active = FaultPlan(**parse_spec(spec))
    return _active


def _parse_slow_stage(spec: str) -> dict[str, float]:
    """`"device:100"` (or `"device:100;fetch:25"`) -> {stage: seconds}."""
    delays: dict[str, float] = {}
    for pair in spec.split(";"):
        pair = pair.strip()
        if not pair:
            continue
        stage, sep, ms = pair.partition(":")
        if not sep:
            raise ValueError(
                f"bad slow_stage entry {pair!r}: expected <stage>:<ms>"
            )
        try:
            delays[stage.strip()] = float(ms) / 1000.0
        except ValueError:
            raise ValueError(
                f"bad slow_stage entry {pair!r}: ms must be a number"
            ) from None
    return delays


def stage_delay_s(stage: str) -> float:
    """Injected latency (seconds) for a named pipeline stage; 0.0 when no
    plan is active."""
    plan = _active
    if plan is None or not plan.slow_stage:
        return 0.0
    return _parse_slow_stage(plan.slow_stage).get(stage, 0.0)


def sleep_stage(stage: str) -> None:
    """Blocking form for worker-thread stage sites (the engine's staging,
    fetch and postprocess windows run in threads)."""
    delay = stage_delay_s(stage)
    if delay > 0.0:
        time.sleep(delay)


async def on_fetch(url: str) -> bytes | None:
    """Detector fetch hook: returns substitute bytes, raises, sleeps, or
    (the usual case) returns None meaning "fetch normally"."""
    plan = _active
    if plan is None:
        return None
    if plan.fetch_delay_s > 0:
        await asyncio.sleep(plan.fetch_delay_s)
    if plan._consume("fetch_error"):
        import httpx

        raise httpx.ConnectError(f"injected fetch failure for {url}")
    if plan._consume("malformed_image"):
        return MALFORMED_BYTES
    return None


def poison_image(image):
    """Tag a PIL image as poisonous: while a `poison_item` plan is active,
    every engine call whose batch contains it raises. Returns the image."""
    setattr(image, POISON_ATTR, True)
    return image


def on_engine_batch(images: list) -> None:
    """Batcher worker-thread hook, called just before engine.detect on the
    first attempt and on every bisect-retry sub-batch."""
    plan = _active
    if plan is None:
        return
    if plan.engine_hang_s > 0:
        plan.release.wait(plan.engine_hang_s)
    if plan._consume("engine_error"):
        raise RuntimeError(f"injected engine failure (batch of {len(images)})")
    if plan.poison_item and any(
        getattr(im, POISON_ATTR, False) for im in images
    ):
        raise RuntimeError(
            f"injected poison image broke its batch (batch of {len(images)})"
        )


def on_engine_dispatch(n_images: int, device_ids: list) -> None:
    """Engine dispatch hook (inside detect, after staging): a device OOM
    with the marker the failure classifier keys on."""
    plan = _active
    if plan is None:
        return
    if plan._consume("engine_oom"):
        raise RuntimeError(
            f"injected device OOM: RESOURCE_EXHAUSTED while allocating batch "
            f"of {n_images}"
        )


def on_cache(op: str, key: str) -> None:
    """ResultCache hook, called on every get and put (positive and
    negative). The cache contains what this raises: a miss or a skipped
    fill, never a failed request."""
    plan = _active
    if plan is None:
        return
    if plan._consume("cache_error"):
        raise RuntimeError(f"injected cache failure ({op} {key!r})")


def take_overload_spike() -> bool:
    """AdaptiveLimiter hook: consume one armed overload-spike tick."""
    plan = _active
    if plan is None:
        return False
    return plan._consume("overload_spike")


def _in_scope(plan: FaultPlan, replica_id: str | None) -> bool:
    """An `only_replica` plan fires only for the matching replica id; an
    unscoped plan fires everywhere."""
    return not plan.only_replica or (
        replica_id is not None and replica_id == plan.only_replica
    )


def replica_delay_s(replica_id: str | None = None) -> float:
    """Whole-replica slowdown (seconds per engine call); 0.0 when no plan is
    active. The stub engine sleeps it inside its device window, so the
    slowdown shows in traces and stage histograms like a throttled card."""
    plan = _active
    if plan is None or plan.slow_replica <= 0 or not _in_scope(plan, replica_id):
        return 0.0
    return plan.slow_replica / 1000.0


def take_flaky(replica_id: str | None = None) -> bool:
    """/detect handler hook: True when this request should answer 500.
    Bresenham-style thinning: `flaky=25` fails exactly every 4th request."""
    plan = _active
    if plan is None or plan.flaky <= 0:
        return False
    if not _in_scope(plan, replica_id):
        return False
    with plan._lock:
        plan._flaky_credit += min(plan.flaky, 100)
        if plan._flaky_credit >= 100:
            plan._flaky_credit -= 100
            return True
    return False


# ---- output-integrity seams ----


def perturb_detections(dets: list) -> list:
    """Deterministic plausible garbage: same labels and shapes, scores and
    boxes moved far outside the obs/compare.py tolerances: an HTTP 200 with
    a confident wrong answer."""
    out = []
    for d in dets or []:
        if isinstance(d, dict):
            d = dict(d)
            try:
                score = float(d.get("score", 0.0))
            except (TypeError, ValueError):
                score = 0.0
            # move the score ~0.17 (>> score_tol) while keeping it a
            # confident, above-threshold answer
            if score < 0.8:
                d["score"] = round(min(score + 0.17, 0.99), 4)
            else:
                d["score"] = round(max(score - 0.17, 0.01), 4)
            box = d.get("box")
            if isinstance(box, (list, tuple)) and len(box) == 4:
                d["box"] = [float(v) + 17.0 for v in box]
        out.append(d)
    return out


def corrupt_detections(dets: list, replica_id: str | None = None) -> list:
    """Engine-output hook: while an `sdc=<pct>` plan is in scope, perturb
    that share of answers (Bresenham credit, like `flaky`). Identity when
    not armed."""
    plan = _active
    if plan is None or plan.sdc <= 0 or not _in_scope(plan, replica_id):
        return dets
    with plan._lock:
        plan._sdc_credit += min(plan.sdc, 100)
        if plan._sdc_credit < 100:
            return dets
        plan._sdc_credit -= 100
    return perturb_detections(dets)


def take_corrupt_weights() -> int:
    """Bring-up hook: consume the whole armed count in one go. The caller
    perturbs that many device params before the `verifying` gate, which
    must then fail attestation and exit 86."""
    plan = _active
    if plan is None:
        return 0
    with plan._lock:
        n = plan.corrupt_weights
        plan.corrupt_weights = 0
    return max(n, 0)


def take_corrupt_compile_cache() -> bool:
    """Golden-probe hook: one-shot miscompiled program. The probe's observed
    answer is perturbed while the weights attest clean, so only the probe
    can catch it."""
    plan = _active
    if plan is None:
        return False
    return plan._consume("corrupt_compile_cache")


# ---- tenant-isolation drills and the wire ----


def _parse_tenant_flood(spec: str) -> tuple[str, float]:
    """`"abuser:8"` -> ("abuser", 8.0): the named tenant floods at that
    multiple of its sustained quota rate."""
    tenant, sep, mult = spec.partition(":")
    tenant = tenant.strip()
    if not sep or not tenant:
        raise ValueError(f"bad tenant_flood entry {spec!r}: expected <tenant>:<xQuota>")
    try:
        factor = float(mult)
    except ValueError:
        raise ValueError(f"bad tenant_flood entry {spec!r}: xQuota must be a number") from None
    if factor <= 0:
        raise ValueError(f"bad tenant_flood entry {spec!r}: xQuota must be > 0")
    return tenant, factor


def tenant_flood_spec() -> tuple[str, float] | None:
    """Drill load-generator hook: (tenant, xQuota) while a tenant_flood plan
    is active, else None. The generator sends the named tenant's traffic at
    xQuota times its sustained rate; the serving path is unchanged."""
    plan = _active
    if plan is None or not plan.tenant_flood:
        return None
    return _parse_tenant_flood(plan.tenant_flood)


def tenant_retry_storm_n() -> int:
    """Drill load-generator hook: how many immediate re-sends (ignoring
    Retry-After) the abusive client fires per shed; 0 when not armed."""
    plan = _active
    if plan is None:
        return 0
    return max(plan.tenant_retry_storm, 0)


def corrupt_frame_bytes(data: bytes, replica_id: str | None = None) -> bytes:
    """Response-encode hook: while armed, flip one byte near the tail of the
    encoded frame (a CRC-protected segment byte) and consume one
    `corrupt_frame` unit. Identity when not armed."""
    plan = _active
    if plan is None or not data or not _in_scope(plan, replica_id):
        return data
    if not plan._consume("corrupt_frame"):
        return data
    idx = max(len(data) - 2, 0)
    return data[:idx] + bytes([data[idx] ^ 0xFF]) + data[idx + 1:]
