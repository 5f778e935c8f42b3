"""Async micro-batcher: many concurrent requests -> few big device batches
(port of spotter_tpu.engine.batcher).

Each request submits images to a shared queue; a pump task drains up to
max_batch images or waits at most max_delay_ms, then runs the engine in a
worker thread (the device work releases the GIL). Up to `max_in_flight`
batches run at once, so one batch's host staging overlaps another's device
compute. A failed batch rejects only its own futures.

What it keeps of the JAX batcher:
- the bounded queue (`SPOTTER_TPU_QUEUE_DEPTH`, shed with `QueueFullError`),
  per-request `Deadline`s, the hung-engine watchdog
  (`SPOTTER_TPU_BATCH_TIMEOUT_MS`), the `CircuitBreaker`, and `drain()`;
- the fault domain: plain errors are bisect-retried (split in half, bounded
  by `SPOTTER_TPU_POISON_MAX_SPLITS`) so only a poisonous item's future
  fails with `PoisonImageError`; a `FatalEngineError` fails the batch and
  calls `fatal_exit_cb(FATAL_ENGINE_EXIT_CODE)`. The port serves one device,
  so there is no degraded rebuild to try first;
- the `Scheduler` (FIFO, or ragged with `SPOTTER_TPU_RAGGED=1`: slack
  order and, for a shortest-edge family, mixed-size photos packed into one
  snapped canvas), which never mixes two open-vocabulary query sets in one
  batch (each batch's `qset` goes to `engine.detect`); a pack's canvas goes
  to `engine.detect` only where its signature takes `canvas_hw` (a stub's
  `detect(images)` gets none), rides through the poison bisect, and each
  dispatch's padded-pixel waste lands in `record_pack`; and the opt-in overload tier
  (`SPOTTER_TPU_ADMIT_TARGET_MS`: AIMD limiter and
  brownout ladder);
- keyed coalescing: `submit(..., key=<content hash>)` while a keyed entry
  is in flight attaches a waiter instead of enqueuing the image again, so N
  byte-identical images cost one engine slot. Every keyed caller awaits a
  private waiter future (one waiter's deadline never cancels the shared
  entry) and gets its own copy of the detections. On completion the
  optional `result_cache` is filled: success -> a positive entry, a
  `PoisonImageError` -> a negative entry; sheds, deadlines and transient
  or fatal engine errors are never cached. Unkeyed submits (the cache off,
  the golden probe) take the plain path;
- tenancy (`attach_tenancy`): the tenant id rides each `QueueItem`, the
  scheduler orders tenants by DRR, the limiter revokes the top-occupancy
  tenant's bulk first, and brownout rung 4 sheds only over-share tenants.

It carries each request's trace (obs/trace.py): the item's `queue_wait`
span, and the batch's traces handed to the engine's worker thread, which
fans its stage windows out to them; a failed item pins its trace, and a
fatal exit records the batch's traces and dumps the flight recorder. The
fault seams `on_engine_batch` and `slow_stage=queue_wait` sit where the
JAX batcher has them.

Not ported yet: the degraded-dp rebuild with its integrity recheck
(ROADMAP Queue 1 item 10).
"""

import asyncio
import inspect
import logging
import time
from typing import Callable, Optional

from spotter_tpu_torch.engine.errors import (
    DEFAULT_POISON_MAX_SPLITS,
    FATAL_ENGINE_EXIT_CODE,
    POISON_MAX_SPLITS_ENV,
    FatalEngineError,
    PoisonImageError,
    TransientEngineError,
)
from spotter_tpu_torch import obs
from spotter_tpu_torch.engine.scheduler import PackPlan, QueueItem, Scheduler
from spotter_tpu_torch.serving.overload import (
    BULK,
    SLO,
    AdaptiveLimiter,
    AdmitLimitError,
    BrownoutController,
    BrownoutShedError,
    build_overload_control,
)
from spotter_tpu_torch.serving.resilience import (
    BATCH_TIMEOUT_ENV,
    DEFAULT_BATCH_TIMEOUT_MS,
    DEFAULT_DRAIN_TIMEOUT_S,
    DEFAULT_QUEUE_DEPTH,
    DRAIN_TIMEOUT_ENV,
    QUEUE_DEPTH_ENV,
    CircuitBreaker,
    CircuitOpenError,
    Deadline,
    DrainingError,
    QueueFullError,
    _env_float,
    _env_int,
    jittered_retry_after,
)
from spotter_tpu_torch.testing import faults

logger = logging.getLogger(__name__)

# default for MicroBatcher(limiter=/brownout=...): build from the env knobs
# (None when SPOTTER_TPU_ADMIT_TARGET_MS is unset/0). Pass None to force
# the overload-control tier off regardless of the env.
_FROM_ENV = object()


class BatchTimeoutError(RuntimeError):
    """The watchdog gave up on a hung engine call; the batch's futures fail
    with this instead of waiting forever (the orphaned worker thread keeps
    running, but its slot is released and its result discarded)."""


class MicroBatcher:
    def __init__(
        self,
        engine,
        max_batch: Optional[int] = None,
        max_delay_ms: float = 5.0,
        max_in_flight: int = 2,
        max_queue: Optional[int] = None,
        batch_timeout_ms: Optional[float] = None,
        breaker: Optional[CircuitBreaker] = None,
        poison_max_splits: Optional[int] = None,
        fatal_exit_cb: Optional[Callable[[int], None]] = None,
        limiter: Optional[AdaptiveLimiter] = _FROM_ENV,
        brownout: Optional[BrownoutController] = _FROM_ENV,
        scheduler: Optional[Scheduler] = None,
    ) -> None:
        """`max_queue`/`batch_timeout_ms` default from the env knobs;
        `max_queue <= 0` means unbounded, `batch_timeout_ms <= 0` disables
        the watchdog. `poison_max_splits <= 0` disables the bisect (a failed
        batch fails whole). `fatal_exit_cb` is called with
        `FATAL_ENGINE_EXIT_CODE` on a fatal device error; the serving
        runtime wires `os._exit` here, and None (library use, tests) leaves
        the breaker to shed."""
        self.engine = engine
        self.max_batch = max_batch or engine.batch_buckets[-1]
        engine.metrics.set_aggregate_bucket(self.max_batch)
        self.max_delay_s = max_delay_ms / 1000.0
        self.max_in_flight = max(1, max_in_flight)
        if max_queue is None:
            max_queue = _env_int(QUEUE_DEPTH_ENV, DEFAULT_QUEUE_DEPTH)
        self.max_queue = max_queue
        if batch_timeout_ms is None:
            batch_timeout_ms = _env_float(BATCH_TIMEOUT_ENV, DEFAULT_BATCH_TIMEOUT_MS)
        self.batch_timeout_s = batch_timeout_ms / 1000.0 if batch_timeout_ms > 0 else None
        self.breaker = breaker or CircuitBreaker.from_env(metrics=engine.metrics)
        if poison_max_splits is None:
            poison_max_splits = _env_int(POISON_MAX_SPLITS_ENV, DEFAULT_POISON_MAX_SPLITS)
        self.poison_max_splits = poison_max_splits
        self.fatal_exit_cb = fatal_exit_cb
        # a `caching.ResultCache`, filled from keyed submits, which the
        # detector that owns it sets; keyed coalescing works with or without
        self.result_cache = None
        # with the limiter armed the queue is unbounded: the adaptive limit
        # is the bound
        if limiter is _FROM_ENV or brownout is _FROM_ENV:
            env_limiter, env_brownout = build_overload_control(metrics=engine.metrics)
            if limiter is _FROM_ENV:
                limiter = env_limiter
            if brownout is _FROM_ENV:
                brownout = env_brownout
        self.limiter = limiter
        self.brownout = brownout
        # the pending buffer lives here (not in the scheduler) so drain() and
        # stop() account for it; under FIFO it holds between plans only the
        # items of query groups the last plan left pending
        self.scheduler = scheduler or Scheduler.from_env(engine)
        # only an engine whose detect takes a canvas gets one (a stub's
        # detect(images) still gets the slack order)
        try:
            self._engine_takes_canvas = "canvas_hw" in inspect.signature(
                engine.detect).parameters
        except (TypeError, ValueError):
            self._engine_takes_canvas = False
        self._sched_buf: list[QueueItem] = []
        # key -> (primary future, waiter futures): one queue entry per key,
        # its result fanned out to every waiter when the primary settles
        self._keyed: dict[str, tuple[asyncio.Future, list[asyncio.Future]]] = {}
        self._fatal_fired = False
        self._queue: asyncio.Queue = asyncio.Queue(
            maxsize=0 if self.limiter is not None else max(0, max_queue)
        )
        self._pump_task: Optional[asyncio.Task] = None
        self._control_task: Optional[asyncio.Task] = None
        self._in_flight: set[asyncio.Task] = set()
        self._slots: Optional[asyncio.Semaphore] = None
        self._closed = False
        self._draining = False
        # True while the pump holds a dequeued-but-undispatched batch: drain()
        # must not read "queue empty, nothing in flight" as done meanwhile
        self._pump_busy = False
        self._fatal_traces: list = []

    @property
    def draining(self) -> bool:
        return self._draining or self._closed

    def in_flight(self, key: str) -> bool:
        """True while a keyed entry for `key` is in flight: a submit with
        this key now would coalesce onto it (the detector's
        `X-Cache: coalesced`)."""
        entry = self._keyed.get(key)
        return entry is not None and not entry[0].done()

    def attach_tenancy(self, plane) -> None:
        """Wire the tenant isolation plane into the scheduler's DRR order,
        the limiter's revocation and the brownout's rung 4. None (tenancy
        unconfigured) leaves all three as built."""
        if plane is None:
            return
        self.scheduler.tenancy = plane
        if self.limiter is not None:
            self.limiter.tenancy = plane
        if self.brownout is not None:
            self.brownout.tenancy = plane

    async def start(self) -> None:
        """Idempotent; an explicit start() after stop()/drain() re-opens the
        batcher (submit() never restarts a stopped batcher on its own)."""
        if self._pump_task is None:
            self._closed = False
            self._draining = False
            self.engine.metrics.set_draining(False)
            self._slots = asyncio.Semaphore(self.max_in_flight)
            self._pump_task = asyncio.create_task(self._pump())
            if self._control_task is None and (
                self.limiter is not None or self.brownout is not None
            ):
                # idle-path control ticks: the AIMD limit must recover and
                # the brownout ladder disarm even with no traffic
                self._control_task = asyncio.create_task(self._control_loop())

    async def _control_loop(self) -> None:
        interval = self.limiter.interval_s if self.limiter is not None else 0.25
        while True:
            await asyncio.sleep(interval)
            if self.limiter is not None:
                self.limiter.tick()
            if self.brownout is not None:
                self.brownout.evaluate()

    async def stop(self) -> None:
        self._closed = True
        for name in ("_control_task", "_pump_task"):
            task = getattr(self, name)
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
                setattr(self, name, None)
        # let dispatched batches finish (their futures get real results) ...
        if self._in_flight:
            await asyncio.gather(*self._in_flight, return_exceptions=True)
        # ... then fail anything still queued or pending so no caller waits forever
        while not self._queue.empty():
            fut = self._queue.get_nowait().fut
            if not fut.done():
                fut.set_exception(DrainingError("MicroBatcher stopped"))
        for item in self._sched_buf:
            if not item.fut.done():
                item.fut.set_exception(DrainingError("MicroBatcher stopped"))
        self._sched_buf.clear()

    async def drain(self, timeout_s: Optional[float] = None) -> dict:
        """Graceful shutdown: stop admitting, let the pump flush the queue,
        wait for in-flight batches, then stop. Returns a summary; on timeout
        any leftovers are failed by stop() rather than stranded."""
        if timeout_s is None:
            timeout_s = _env_float(DRAIN_TIMEOUT_ENV, DEFAULT_DRAIN_TIMEOUT_S)
        t0 = time.monotonic()
        self._draining = True
        self.engine.metrics.set_draining(True)
        deadline = t0 + timeout_s
        while (
            not self._queue.empty() or self._pump_busy or self._in_flight
        ) and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        leftover = self._queue.qsize() + sum(1 for it in self._sched_buf if not it.fut.done())
        in_flight = sum(1 for t in self._in_flight if not t.done()) + int(self._pump_busy)
        await self.stop()
        return {
            "status": "drained" if leftover == 0 and in_flight == 0 else "drain_timeout",
            "queued_failed": leftover,
            "in_flight": in_flight,
            "waited_ms": (time.monotonic() - t0) * 1000.0,
        }

    async def submit(
        self, image, deadline: Optional[Deadline] = None, key: Optional[str] = None,
        cls: Optional[str] = None, qset=None, tenant: Optional[str] = None,
        info: Optional[dict] = None,
    ) -> list[dict]:
        """One image in, its detections out (awaits the batched device call).

        Raises `DrainingError` / `CircuitOpenError` / `QueueFullError` (or,
        with the overload tier armed, `AdmitLimitError` /
        `BrownoutShedError`) at admission, and `DeadlineExceededError` when
        `deadline` expires before the result lands. `cls` ("slo" | "bulk",
        None means slo) matters only with the overload tier armed: bulk
        sheds strictly before slo. `qset` (a `caching.text_cache.QuerySet`)
        runs an open-vocabulary model against the request's own queries; it
        is also the item's batch group. `info` (a dict) gets the bucket the
        item ran in under "bucket" and the ragged canvas it was staged into
        under "canvas" (None: the static bucket), which the golden probe
        reads.

        `key` (the result cache's content key) coalesces: while a keyed
        entry is in flight, a submit with the same key attaches a waiter
        and adds no engine work (so no breaker or capacity check). Every
        keyed caller, the first included, awaits its own waiter future and
        gets its own copy of the detections. `tenant` (the resolved tenant
        id) rides the item for the DRR order and the per-tenant scoping of
        the overload tier. None for both keeps the plain path.
        """
        metrics = self.engine.metrics
        if self.draining:
            metrics.record_shed()
            raise DrainingError("MicroBatcher is draining or stopped")
        await self.start()
        loop = asyncio.get_running_loop()
        if key is not None:
            entry = self._keyed.get(key)
            if entry is not None and not entry[0].done():
                metrics.record_coalesced_submit()
                waiter: asyncio.Future = loop.create_future()
                entry[1].append(waiter)
                return await self._await_result(waiter, deadline, metrics)
        if not self.breaker.allow():
            metrics.record_shed()
            raise CircuitOpenError(
                "circuit breaker open (engine failing)",
                retry_after_s=self.breaker.retry_after_s(),
            )
        if deadline is not None and deadline.expired():
            metrics.record_deadline_exceeded()
            raise deadline.exceeded("queue admission")
        cls = BULK if cls == BULK else SLO
        adm = self._admit(cls, metrics, tenant)
        fut: asyncio.Future = loop.create_future()
        if adm is not None:
            # release the slot however the result lands; idempotent with the
            # limiter's own revocation release
            fut.add_done_callback(lambda f, a=adm: a.release())
        if key is not None:
            waiters: list[asyncio.Future] = []
            self._keyed[key] = (fut, waiters)
            # the callback holds its own waiters list: a later submit may
            # replace the dict entry once this primary is done
            fut.add_done_callback(lambda f, k=key, ws=waiters: self._settle_keyed(k, f, ws))
        try:
            # a keyed entry carries no deadline: the shared primary must
            # outlive any one waiter's budget
            self._queue.put_nowait(QueueItem(
                image=image, fut=fut, deadline=deadline if key is None else None,
                trace=obs.current_trace(), t_submit=time.monotonic(), adm=adm, cls=cls,
                tenant=tenant, qset=qset, info=info,
            ))
        except asyncio.QueueFull:
            if key is not None and self._keyed.get(key, (None,))[0] is fut:
                del self._keyed[key]
            metrics.record_shed()
            raise QueueFullError(
                f"batch queue full ({self.max_queue} deep)",
                retry_after_s=jittered_retry_after(max(self.max_delay_s * 2.0, 0.05)),
            ) from None
        if adm is not None and cls == BULK:
            # newest-bulk-first revocation target for an over-limit slo arrival
            adm.attach_revoke(lambda f=fut: None if f.done() else f.set_exception(
                AdmitLimitError(
                    "bulk entry revoked for an slo admission",
                    retry_after_s=jittered_retry_after(max(self.max_delay_s * 2.0, 0.05)),
                )
            ))
        if key is None:
            return await self._await_result(fut, deadline, metrics)
        waiter = loop.create_future()
        waiters.append(waiter)
        return await self._await_result(waiter, deadline, metrics)

    def _admit(self, cls: str, metrics, tenant: Optional[str] = None):
        """Overload-tier admission; None when the tier is off (the bounded
        queue below is then the only gate). `tenant` scopes brownout rung 4
        and tags the admission for top-occupancy revocation."""
        if self.brownout is not None:
            self.brownout.evaluate()
            if cls == BULK and self.brownout.shed_bulk(tenant):
                metrics.record_shed()
                metrics.record_admit_shed(BULK)
                raise BrownoutShedError(
                    f"brownout: bulk traffic shed (rung {self.brownout.rung})",
                    retry_after_s=jittered_retry_after(self.brownout.disarm_s),
                )
        if self.limiter is None:
            return None
        adm = self.limiter.try_admit(cls, tenant)
        if adm is None:
            metrics.record_shed()
            raise AdmitLimitError(
                f"adaptive admission limit hit ({self.limiter.limit} in flight)",
                retry_after_s=jittered_retry_after(max(self.max_delay_s * 2.0, 0.05)),
            )
        return adm

    async def _await_result(
        self, fut: asyncio.Future, deadline: Optional[Deadline], metrics
    ) -> list[dict]:
        if deadline is None:
            return await fut
        try:
            # shield: wait_for must not cancel the pump's handle on the future;
            # on expiry we cancel it ourselves so the pump skips the entry
            return await asyncio.wait_for(asyncio.shield(fut), max(deadline.remaining(), 0.0))
        except asyncio.TimeoutError:
            if fut.done() and not fut.cancelled():
                fut.exception()  # landed on the expiry tick: consume it
            else:
                fut.cancel()
            metrics.record_deadline_exceeded()
            raise deadline.exceeded("batched detect") from None

    def _settle_keyed(self, key: str, primary: asyncio.Future,
                      waiters: list[asyncio.Future]) -> None:
        """The primary future's done callback: retire the keyed entry (if it
        is still this one), fill the result cache (success -> positive,
        poison -> negative; nothing else is cached), and fan the outcome out
        to every waiter, each with its own copy. No waiter can attach once
        the primary is done, so `waiters` is complete here."""
        entry = self._keyed.get(key)
        if entry is not None and entry[0] is primary:
            del self._keyed[key]
        cache = self.result_cache
        if primary.cancelled():  # defensive: nothing cancels keyed primaries
            for w in waiters:
                if not w.done():
                    w.cancel()
            return
        exc = primary.exception()
        if exc is None:
            result = primary.result()
            if cache is not None:
                cache.put(key, result)
            for w in waiters:
                if not w.done():
                    w.set_result([dict(d) for d in result])
        else:
            if cache is not None and isinstance(exc, PoisonImageError):
                cache.put_negative(key, exc)
            for w in waiters:
                if not w.done():
                    w.set_exception(exc)

    async def _pump(self) -> None:
        buf = self._sched_buf
        while True:
            self._pump_busy = bool(buf)
            if not buf:
                first = await self._queue.get()
                self._pump_busy = True
                if first.fut.done():  # deadline-cancelled while queued
                    continue
                buf.append(first)
            try:
                target = self._dispatch_bucket()
                gather = self.scheduler.gather_target(target)
                # top up within one bounded delay window
                deadline = time.monotonic() + self.max_delay_s
                while len(buf) < gather:
                    if len(buf) >= target:
                        # past the fill target the ragged lookahead takes only
                        # what is already queued
                        try:
                            item = self._queue.get_nowait()
                        except asyncio.QueueEmpty:
                            break
                    else:
                        timeout = deadline - time.monotonic()
                        if timeout <= 0:
                            break
                        try:
                            item = await asyncio.wait_for(self._queue.get(), timeout)
                        except asyncio.TimeoutError:
                            break
                    if not item.fut.done():
                        buf.append(item)
                buf[:] = [it for it in buf if not it.fut.done()]
                if not buf:
                    continue
                await self._slots.acquire()
                if not self.scheduler.fifo:
                    # slack ordering: what queued while we waited for a slot
                    # joins the plan
                    while len(buf) < gather:
                        try:
                            item = self._queue.get_nowait()
                        except asyncio.QueueEmpty:
                            break
                        if not item.fut.done():
                            buf.append(item)
                plan = self.scheduler.plan(buf, target)
            except asyncio.CancelledError:
                # stop() cancelled us while we hold items no task owns yet
                for item in buf:
                    if not item.fut.done():
                        item.fut.set_exception(DrainingError("MicroBatcher stopped"))
                buf.clear()
                raise
            task = asyncio.create_task(self._run_batch(plan))
            self._in_flight.add(task)
            task.add_done_callback(self._in_flight.discard)

    def _dispatch_bucket(self) -> int:
        """The fill target: `max_batch`, capped one rung down the engine's
        ladder while the brownout bucket-cap rung is active."""
        if self.brownout is None or not self.brownout.bucket_cap_active():
            return self.max_batch
        below = [b for b in self.engine.batch_buckets if b < self.max_batch]
        return below[-1] if below else self.max_batch

    def _detect_outcomes(self, images: list, splits_left: int, canvas_hw=None, qset=None,
                         buckets: Optional[list] = None) -> list:
        """Worker-thread engine call with the poison bisect-retry.

        Returns one outcome per image: a detections list, or the exception
        for that image's future. A failed multi-image batch is split in half
        and each half retried (recursing up to `splits_left` deep), so a
        deterministic per-input failure converges to one `PoisonImageError`
        while every innocent neighbour gets its result. Typed engine errors
        (transient after the engine's own retry, fatal) are never bisected.
        `canvas_hw` (the pack's ragged canvas) rides through the recursion,
        so the halves stay in the pack's canvas. `buckets`, when given, gets
        the bucket each image ran in (None for a failed one), in order.
        """
        try:
            # the fault seam runs at every level, where a wedged or poisoned
            # device call would fail on a retry too
            faults.on_engine_batch(images)
            kwargs = {}
            if canvas_hw is not None:
                kwargs["canvas_hw"] = canvas_hw
            if qset is not None:
                kwargs["qset"] = qset
            out = list(self.engine.detect(images, **kwargs))
            if buckets is not None:
                buckets.extend(self.engine.ran_buckets())
            return out
        except (FatalEngineError, TransientEngineError):
            raise
        except Exception as exc:
            if (len(images) == 1 or splits_left <= 0) and buckets is not None:
                buckets.extend([None] * len(images))
            if len(images) == 1:
                err = PoisonImageError(f"image poisoned its batch: {exc!r}")
                err.__cause__ = exc
                return [err]
            if splits_left <= 0:
                return [exc] * len(images)
            self.engine.metrics.record_batch_retry()
            mid = len(images) // 2
            return self._detect_outcomes(
                images[:mid], splits_left - 1, canvas_hw, qset, buckets
            ) + self._detect_outcomes(images[mid:], splits_left - 1, canvas_hw, qset, buckets)

    async def _run_batch(self, plan: PackPlan) -> None:
        try:
            batch = [item for item in plan.items if not item.fut.done()]
            if not batch:
                return
            images = [item.image for item in batch]
            canvas_hw = plan.canvas_hw if self._engine_takes_canvas else None
            # the scheduler packs one query group per plan, so the first
            # item's query set is the whole batch's
            qset = batch[0].qset
            # slow_stage=queue_wait:<ms> lands inside the queue_wait span
            qw_delay = faults.stage_delay_s(obs.QUEUE_WAIT)
            if qw_delay > 0.0:
                await asyncio.sleep(qw_delay)
            t_dispatch = time.monotonic()
            queue_waits_ms, slack_ms, traces = [], [], []
            for item in batch:
                wait_ms = (t_dispatch - item.t_submit) * 1000.0
                queue_waits_ms.append(wait_ms)
                if item.deadline is not None:
                    slack_ms.append(item.deadline.remaining() * 1000.0)
                if self.limiter is not None:
                    self.limiter.observe(wait_ms)  # the AIMD control signal
                if item.adm is not None:
                    # dispatched work leaves the revocation stack
                    item.adm.make_unrevocable()
                if item.trace is not None:
                    item.trace.add_span(obs.QUEUE_WAIT, item.t_submit, t_dispatch)
                    traces.append(item.trace)
            metrics = self.engine.metrics
            metrics.record_stage_samples(obs.QUEUE_WAIT, queue_waits_ms)
            metrics.record_pack(padding_waste_pct=plan.padding_waste_pct, slack_ms=slack_ms,
                                ragged=canvas_hw is not None)
            # the worker thread inherits this through asyncio.to_thread's
            # context copy and fans its stage windows out to these traces
            obs.set_batch_traces(traces)
            # the bucket each image ran in, for the items that ask (the probe)
            buckets = [] if any(item.info is not None for item in batch) else None
            try:
                detect = asyncio.to_thread(self._detect_outcomes, images,
                                           self.poison_max_splits, canvas_hw, qset, buckets)
                if self.batch_timeout_s is not None:
                    outcomes = await asyncio.wait_for(detect, self.batch_timeout_s)
                else:
                    outcomes = await detect
            except asyncio.TimeoutError:
                # watchdog: fail this batch and release the slot; the breaker
                # decides whether to keep admitting
                metrics.record_batch_timeout(len(batch))
                self.breaker.record_failure()
                exc = BatchTimeoutError(
                    f"engine batch of {len(batch)} timed out after "
                    f"{self.batch_timeout_s:.1f} s (watchdog)"
                )
                self._fail(batch, exc)
                return
            except FatalEngineError as exc:
                self._handle_fatal(batch, exc)
                return
            except Exception as exc:  # transient-after-retry or unexpected
                metrics.record_error(len(batch))
                self.breaker.record_failure()
                self._fail(batch, exc)
                return
            for item, bucket in zip(batch, buckets or ()):
                if item.info is not None:
                    item.info["bucket"] = bucket
                    item.info["canvas"] = canvas_hw
            self._settle_outcomes(batch, outcomes)
        finally:
            self._slots.release()

    @staticmethod
    def _fail(batch, exc: BaseException) -> None:
        for item in batch:
            if not item.fut.done():
                item.fut.set_exception(exc)

    def _settle_outcomes(self, batch, outcomes: list) -> None:
        """Per-image results/errors plus the breaker accounting: an isolated
        poison (some co-batched items succeeded) is not an engine failure; a
        batch where nothing succeeded is."""
        failed = [o for o in outcomes if isinstance(o, BaseException)]
        all_failed = failed and len(failed) == len(outcomes)
        metrics = self.engine.metrics
        if all_failed:
            self.breaker.record_failure()
            metrics.record_error(len(failed))
        else:
            self.breaker.record_success()
            if failed:
                metrics.record_poison_isolated(
                    sum(1 for o in failed if isinstance(o, PoisonImageError))
                )
                metrics.record_error(len(failed))
        for item, out in zip(batch, outcomes):
            f = item.fut
            if isinstance(out, BaseException) and item.trace is not None:
                # pin the trace even when the future is already settled (a
                # deadline-expired waiter): a poison post-mortem starts there
                item.trace.set_error(type(out).__name__, str(out))
            if f.done():
                continue
            if isinstance(out, BaseException):
                # when the whole batch failed nothing was isolated: surface
                # the underlying error, not the "poison" label
                if all_failed and isinstance(out, PoisonImageError) and out.__cause__ is not None:
                    f.set_exception(out.__cause__)
                else:
                    f.set_exception(out)
            else:
                f.set_result(out)

    def _handle_fatal(self, batch, exc: FatalEngineError) -> None:
        """The device (or its CUDA context) died mid-batch: fail this batch's
        futures, then hand the process to the supervisor. A poisoned context
        fails every later call too, so nothing is retried."""
        metrics = self.engine.metrics
        metrics.record_fatal_engine_error()
        metrics.record_error(len(batch))
        self.breaker.record_failure()
        self._fatal_traces = []
        for item in batch:
            if item.trace is not None:
                item.trace.set_error("fatal", str(exc))
                self._fatal_traces.append(item.trace)
        self._fail(batch, exc)
        if self._fatal_fired:
            return
        self._fatal_fired = True
        if self.fatal_exit_cb is not None:
            logger.error(
                "fatal engine error; exiting %d for a supervisor restart: %s",
                FATAL_ENGINE_EXIT_CODE, exc,
            )
            # the batch's traces never reach an HTTP handler on this path
            # (the exit is next): record them and dump the recorder, so which
            # request killed the replica is answerable after the restart
            for trace in self._fatal_traces:
                obs.get_recorder().record(trace)
            obs.dump_for_exit(FATAL_ENGINE_EXIT_CODE)
            self.fatal_exit_cb(FATAL_ENGINE_EXIT_CODE)
