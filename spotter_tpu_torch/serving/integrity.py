"""Output-integrity plane of the replica (port of
spotter_tpu.serving.integrity): a healthy, fast replica that answers wrong
(a flipped weight bit after a restore, a bad program, a card emitting
plausible garbage) is caught before it serves and while it serves.

- **GoldenProbe**: a deterministic per-family probe image, sent through the
  real batcher (bulk class, so it never displaces slo traffic) and compared
  with the tolerance comparator (obs/compare.py). A family with a pinned
  registry answer (`PROBE_REFERENCES`) is held to it; any other family
  self-pins at the `verifying` gate, after attestation has vouched for the
  weights, and every later probe must match.

  On the card the probe's answer depends on the bucket it lands in: under
  `bfloat16` the rounding follows the algorithms cuDNN and cuBLAS pick at
  each batch size, and under SPOTTER_TPU_INT8 the buckets at or above
  SPOTTER_TPU_INT8_MIN_BATCH run another function (they quantize). So the
  gate pins the probe's answer in every bucket of the ladder (`pin`: the
  probe copied to fill the bucket, the copies of one batch held to each
  other), holds each pin to the first pin of the buckets the engine says
  must answer alike (`answer_class`: every bucket of one function under
  `float32`), fails if a bucket is left unpinned, and a later probe is held
  to the pin of the bucket it ran in (the batcher reports it).

  Under ragged packing (SPOTTER_TPU_RAGGED=1) a shortest-edge family's
  answer also depends on the canvas a pack is staged into: each
  convolution spreads the photo into the zero pad beside it, and a smaller
  canvas cuts those features off, so another canvas moves the boxes (past
  compare's 2 px on random weights). The scheduler packs the probe only with photos that fit
  its own snapped canvas (engine/scheduler.py), so every probe, at the gate
  and after, runs at that one canvas; the batcher reports the canvas beside
  the bucket, the gate's pins record it, and a probe that ran at another
  canvas fails rather than be held to a pin it was not taken at.
- **WeightsAttestor**: drives the engine's on-device `attest()`: the
  parameters and buffers against the trusted host copy, then every kept
  derived value a forward reads (engine/engine.py). Runs at every
  verification and on a period.
- **IntegrityPlane**: the two behind the `verifying` lifecycle state
  (serving/lifecycle.py): attestation and the probe must pass before READY
  on a cold start and a restart alike. A failure, at the gate or from the
  periodic loop, pins a flight-recorder trace and exits with
  `INTEGRITY_EXIT_CODE` (86), for a cold restart.

The JAX package's fourth layer, the edge's `QuorumSampler`, has one caller,
the router, and comes with the fleet tier (ROADMAP Queue 1 item 12); the
re-verification after a degraded-dp rebuild comes with multi-GPU serving
(item 10).
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import time
from typing import Callable, Optional

from spotter_tpu_torch import obs
from spotter_tpu_torch.obs import compare
from spotter_tpu_torch.serving.lifecycle import INTEGRITY_EXIT_CODE
from spotter_tpu_torch.serving.overload import BULK
from spotter_tpu_torch.testing import faults

logger = logging.getLogger(__name__)

INTEGRITY_ENV = "SPOTTER_TPU_INTEGRITY"
PROBE_INTERVAL_ENV = "SPOTTER_TPU_PROBE_INTERVAL_S"
ATTEST_INTERVAL_ENV = "SPOTTER_TPU_ATTEST_INTERVAL_S"

DEFAULT_PROBE_INTERVAL_S = 30.0
DEFAULT_ATTEST_INTERVAL_S = 60.0

# Probe canvas: small enough to be negligible host work, big enough to
# exercise the real preprocess/postprocess path.
PROBE_HW = 32


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def integrity_enabled() -> bool:
    """Master switch (default on): readiness verification + periodic
    probe/attest. `SPOTTER_TPU_INTEGRITY=0` disables the whole plane."""
    return os.environ.get(INTEGRITY_ENV, "1").strip() not in ("", "0")


def probe_image(family: str, size: int = PROBE_HW):
    """Deterministic probe image for a model family: a fixed arithmetic
    pixel pattern seeded by the family name, built as an array (never
    through a lossy encoder), so the same bytes reach the engine on every
    platform, process and restart."""
    import numpy as np
    from PIL import Image

    seed = hashlib.blake2b(family.encode(), digest_size=2).digest()
    s0, s1 = seed[0], seed[1]
    y = np.arange(size, dtype=np.uint32)[:, None, None]
    x = np.arange(size, dtype=np.uint32)[None, :, None]
    c = np.arange(3, dtype=np.uint32)[None, None, :]
    arr = ((x * (3 + s0) + y * (7 + s1) + c * 11 + s0) % 256).astype("uint8")
    return Image.fromarray(arr, "RGB")


# Pinned reference answers per model family. The stub family's entry pins
# both the probe-image rule above and the JAX stub engine's content-hash
# detection rule. Real families self-pin at the verifying gate, because
# their answers depend on checkpoint bytes this repository does not pin.
PROBE_REFERENCES: dict[str, list[dict]] = {
    "stub": [{"label": "tv", "score": 0.89, "box": [6.0, 6.0, 24.0, 28.0]}],
}


class GoldenProbe:
    """Golden-probe canary: ask the real serving path the question whose
    answer is known, through the real batcher (bulk class). Every probe
    submits without a content key (the JAX probe's `key=None`): it is never
    coalesced into a user's in-flight forward, never answered from the
    result cache (it does not pass the detector) and never fills it, so
    each probe runs a forward."""

    def __init__(
        self,
        family: str,
        reference: Optional[list[dict]] = None,
        score_tol: float = compare.DEFAULT_SCORE_TOL,
        box_tol: float = compare.DEFAULT_BOX_TOL,
    ) -> None:
        self.family = family
        self.image = probe_image(family)
        # a registry answer holds in every bucket; None: self-pin at the gate
        self.registry = (
            list(reference)
            if reference is not None
            else PROBE_REFERENCES.get(family)
        )
        self.pins: dict[int, list[dict]] = {}  # bucket -> its pinned answer
        # the ragged canvas the pins were taken at (None: the static bucket)
        self.canvas: Optional[tuple[int, int]] = None
        self.score_tol = score_tol
        self.box_tol = box_tol
        self.probes_total = 0
        self.failures_total = 0
        self.last_error: Optional[str] = None

    @property
    def reference(self) -> Optional[list[dict]]:
        """The first bucket's pin (None until the gate has pinned)."""
        return self.pins[min(self.pins)] if self.pins else None

    def _diff(self, reference: list[dict], dets: list[dict]) -> Optional[str]:
        return compare.diff_detections(
            reference, dets, score_tol=self.score_tol, box_tol=self.box_tol)

    def _fail(self, reason: str) -> str:
        self.failures_total += 1
        self.last_error = reason
        return reason

    async def run(self, batcher) -> Optional[str]:
        """One probe through the batcher, held to the pin of the bucket it
        ran in; None on pass, else the reason."""
        self.probes_total += 1
        info: dict = {}
        try:
            dets = await batcher.submit(self.image, cls=BULK, info=info)
        except Exception as exc:  # a probe that cannot run is a failure
            return self._fail(f"probe submit failed: {exc!r}")
        if faults.take_corrupt_compile_cache():
            # miscompiled-program seam: the weights attest clean but the
            # program computes garbage; only this probe can catch it
            dets = faults.perturb_detections(dets)
        bucket = info.get("bucket")
        pinned = self.pins.get(bucket)
        if pinned is None:
            return self._fail(f"probe ran in bucket {bucket}, which has no pin")
        canvas = info.get("canvas")
        if canvas != self.canvas:
            return self._fail(f"probe ran at canvas {canvas}, its pins at {self.canvas}")
        reason = self._diff(pinned, dets)
        return None if reason is None else self._fail(reason)

    async def pin(self, batcher, buckets, answer_class=None) -> Optional[str]:
        """The gate's pins: in each bucket of `buckets`, the probe copied to
        fill it, submitted at once so the copies share one batch; the copies
        of one batch must agree with each other (and with the registry
        answer, for a family that has one). A pin must agree with the first
        pin of its `answer_class(bucket)` (buckets whose class is None answer
        on their own), and every bucket must end up pinned; every copy must
        run at one canvas, which the pins record. None on success, else the
        reason."""
        self.pins = {}
        canvases = set()
        for size in buckets:
            self.probes_total += 1
            infos = [{} for _ in range(size)]
            results = await asyncio.gather(
                *(batcher.submit(self.image, cls=BULK, info=info) for info in infos),
                return_exceptions=True,
            )
            for dets, info in zip(results, infos):
                if isinstance(dets, BaseException):
                    return self._fail(f"probe submit failed: {dets!r}")
                if faults.take_corrupt_compile_cache():
                    dets = faults.perturb_detections(dets)
                bucket = info.get("bucket")
                canvases.add(info.get("canvas"))
                held = self.pins.get(bucket, self.registry)
                if held is None:
                    self.pins[bucket] = [dict(d) for d in dets]
                    continue
                if (reason := self._diff(held, dets)) is not None:
                    return self._fail(f"probe in bucket {bucket}: {reason}")
                self.pins.setdefault(bucket, held)
        missing = [b for b in buckets if b not in self.pins]
        if missing:
            return self._fail(f"buckets {missing} left unpinned")
        if len(canvases) > 1:
            return self._fail(f"probe pinned at several canvases {sorted(canvases, key=str)}")
        self.canvas = canvases.pop() if canvases else None
        first: dict = {}
        for bucket in buckets:
            cls = None if answer_class is None else answer_class(bucket)
            if cls is None:
                continue
            ref = first.setdefault(cls, bucket)
            if ref != bucket and (reason := self._diff(self.pins[ref], self.pins[bucket])):
                return self._fail(f"probe pin of bucket {bucket} disagrees with bucket "
                                  f"{ref}'s: {reason}")
        logger.info("golden probe for %r pinned in buckets %s (%d detections in the first)",
                    self.family, sorted(self.pins), len(self.reference))
        return None

    def snapshot(self) -> dict:
        return {
            "family": self.family,
            "pinned": bool(self.pins),
            "pinned_buckets": sorted(self.pins),
            "pinned_canvas": None if self.canvas is None else list(self.canvas),
            "probes_total": self.probes_total,
            "failures_total": self.failures_total,
            "last_error": self.last_error,
        }


class WeightsAttestor:
    """Runs and counts the on-device `engine.attest()`."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self.attests_total = 0
        self.failures_total = 0
        self.last_error: Optional[str] = None
        self.last_duration_s: float = 0.0

    def attest(self) -> Optional[str]:
        """One attestation; None on pass, else the reason (naming what
        mismatched)."""
        self.attests_total += 1
        t0 = time.monotonic()
        try:
            result = self.engine.attest()
        except Exception as exc:
            self.last_duration_s = time.monotonic() - t0
            self.failures_total += 1
            self.last_error = f"attestation errored: {exc!r}"
            return self.last_error
        self.last_duration_s = time.monotonic() - t0
        if result.get("ok"):
            return None
        self.failures_total += 1
        self.last_error = (
            f"weights checksum mismatch on {result.get('mismatched')} "
            f"(digest {getattr(self.engine, 'weights_digest', lambda: '?')()})"
        )
        return self.last_error

    def snapshot(self) -> dict:
        return {
            "attests_total": self.attests_total,
            "failures_total": self.failures_total,
            "last_duration_s": round(self.last_duration_s, 6),
            "last_error": self.last_error,
        }


class IntegrityPlane:
    """Probe + attestation behind the `verifying` readiness gate and a
    periodic re-verification loop. `exit_cb` (default `os._exit`) is the
    86 path; tests inject a recorder."""

    def __init__(
        self,
        engine,
        batcher,
        family: Optional[str] = None,
        probe_interval_s: Optional[float] = None,
        attest_interval_s: Optional[float] = None,
        exit_cb: Callable[[int], None] = os._exit,
    ) -> None:
        if family is None:
            built = getattr(engine, "built", None)
            family = getattr(built, "model_name", None) or "stub"
        self.engine = engine
        self.batcher = batcher
        self.probe = GoldenProbe(family)
        self.attestor = WeightsAttestor(engine)
        self.probe_interval_s = (
            _env_float(PROBE_INTERVAL_ENV, DEFAULT_PROBE_INTERVAL_S)
            if probe_interval_s is None
            else probe_interval_s
        )
        self.attest_interval_s = (
            _env_float(ATTEST_INTERVAL_ENV, DEFAULT_ATTEST_INTERVAL_S)
            if attest_interval_s is None
            else attest_interval_s
        )
        self.exit_cb = exit_cb
        self.verifications_total = 0
        self.verification_failures_total = 0
        self.last_verify_s: float = 0.0
        self.last_error: Optional[str] = None
        self._task: Optional[asyncio.Task] = None

    async def verify(self, source: str) -> bool:
        """The `verifying` gate: attestation first (the weights vouch for the
        probe's self-pin), then the golden probe through the real batcher,
        pinned in every bucket of the engine's ladder. `source` says why
        ("cold-start" or "warm-restore")."""
        self.verifications_total += 1
        t0 = time.monotonic()
        reason = self.attestor.attest()
        if reason is None:
            reason = await self.probe.pin(
                self.batcher, getattr(self.engine, "batch_buckets", None) or (1,),
                getattr(self.engine, "answer_class", None))
        self.last_verify_s = time.monotonic() - t0
        if reason is None:
            logger.info(
                "integrity verification passed (%s): attest+probe in %.3fs",
                source, self.last_verify_s,
            )
            return True
        self.verification_failures_total += 1
        self.last_error = f"{source}: {reason}"
        logger.error("integrity verification FAILED (%s): %s", source, reason)
        self._pin_trace(source, reason)
        return False

    def _pin_trace(self, source: str, reason: str) -> None:
        """Pin a flight-recorder trace, so `/debug/traces` says what
        disagreed, not just that something did."""
        try:
            recorder = obs.get_recorder()
            if not recorder.enabled:
                return
            request_id = f"integrity-{source}"
            trace = obs.Trace(obs.trace_id_for_request(request_id), request_id)
            trace.set_error("integrity", reason)
            recorder.record(trace)
        except Exception:
            logger.debug("could not pin integrity trace", exc_info=True)

    def integrity_exit(self, reason: str) -> None:
        """The 86 path: dump the flight recorder (a no-op for 86, which is not
        among `obs.DUMP_EXIT_CODES`, as in the JAX package), then exit for a
        cold restart."""
        logger.error(
            "integrity failure (%s); exiting %d for a cold restart",
            reason, INTEGRITY_EXIT_CODE,
        )
        obs.dump_for_exit(INTEGRITY_EXIT_CODE)
        self.exit_cb(INTEGRITY_EXIT_CODE)

    async def start(self) -> None:
        """Start the periodic re-verification loop (probe and attest on
        their own cadences; an interval <= 0 disables that check)."""
        if self._task is None:
            self._task = asyncio.create_task(self._run())

    async def _run(self) -> None:
        now = time.monotonic()
        next_probe = (
            now + self.probe_interval_s if self.probe_interval_s > 0 else None
        )
        next_attest = (
            now + self.attest_interval_s
            if self.attest_interval_s > 0
            else None
        )
        while next_probe is not None or next_attest is not None:
            due = min(t for t in (next_probe, next_attest) if t is not None)
            await asyncio.sleep(max(due - time.monotonic(), 0.01))
            reason = None
            source = None
            if next_attest is not None and time.monotonic() >= next_attest:
                next_attest = time.monotonic() + self.attest_interval_s
                source = "periodic-attest"
                reason = await asyncio.get_running_loop().run_in_executor(
                    None, self.attestor.attest
                )
            if (
                reason is None
                and next_probe is not None
                and time.monotonic() >= next_probe
            ):
                next_probe = time.monotonic() + self.probe_interval_s
                source = "periodic-probe"
                reason = await self.probe.run(self.batcher)
            if reason is not None:
                self.verification_failures_total += 1
                self.last_error = f"{source}: {reason}"
                self._pin_trace(source or "periodic", reason)
                self.integrity_exit(self.last_error)
                return

    async def aclose(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None

    def snapshot(self) -> dict:
        return {
            "verifications_total": self.verifications_total,
            "verification_failures_total": self.verification_failures_total,
            "last_verify_s": round(self.last_verify_s, 6),
            "last_error": self.last_error,
            "probe": self.probe.snapshot(),
            "attest": self.attestor.snapshot(),
        }
