"""Replica lifecycle: startup state machine, exit codes, preemption watcher
(port of spotter_tpu.serving.lifecycle).

- `StartupTracker`: the `loading -> warming -> verifying -> ready` state
  machine behind `/startupz`, so a k8s startupProbe can tell "still loading
  the model and warming the bucket ladder" from "dead". `mark_ready()`
  records `time_to_ready_s` into the engine metrics.
- `PreemptionWatcher`: SIGTERM plus a maintenance-event source
  (`SPOTTER_TPU_PREEMPTION_FILE`: a path whose appearance signals the event;
  `SPOTTER_TPU_PREEMPTION_URL`: a metadata endpoint polled like GCE's
  maintenance-event URL). On the first signal it drains via the detector's
  `drain()`, dumps the flight recorder and exits with
  `PREEMPTED_EXIT_CODE`.

The JAX package also arms its persistent compile cache here; the port
compiles nothing per shape (its kernels build once per source hash under
build/kernels/), so there is nothing to arm.
"""

import asyncio
import logging
import os
import signal
import time
from typing import Awaitable, Callable, Optional

logger = logging.getLogger(__name__)

PREEMPTION_FILE_ENV = "SPOTTER_TPU_PREEMPTION_FILE"
PREEMPTION_URL_ENV = "SPOTTER_TPU_PREEMPTION_URL"
PREEMPTION_POLL_ENV = "SPOTTER_TPU_PREEMPTION_POLL_S"
RESTARTS_ENV = "SPOTTER_TPU_RESTARTS"
# Which fleet pool this replica belongs to ("on_demand" / "spot"), set by
# whatever spawned it. Purely a label: it surfaces in /startupz and /healthz.
POOL_ENV = "SPOTTER_TPU_POOL"

DEFAULT_PREEMPTION_POLL_S = 5.0

# Distinct from any Python/aiohttp crash code: the supervisor restarts a
# preempted replica immediately (capacity came back or k8s rescheduled us)
# instead of treating it as a crash loop.
PREEMPTED_EXIT_CODE = 83

# Startup states, in order. "ready" is terminal for a healthy bring-up;
# "failed" is terminal for a bring-up that raised: the server exits non-zero
# right after marking it so the supervisor/kubelet restart path takes over
# instead of the replica serving 503s forever. "verifying" sits between
# warming and ready: the weights attestation and the golden probe
# (serving/integrity.py) must pass before the replica may serve. A warmup
# that ran fine can still answer wrong (a corrupted restore, a bad
# program), and readiness is the last gate before clients see it.
LOADING = "loading"
WARMING = "warming"
VERIFYING = "verifying"
READY = "ready"
FAILED = "failed"

# Exit code for a failed bring-up: distinct from PREEMPTED_EXIT_CODE (83)
# and the supervisor's CRASH_LOOP_EXIT_CODE (84) so logs tell the three
# apart; the supervisor treats it as a plain crash (exponential backoff).
BRINGUP_FAILED_EXIT_CODE = 82

# Exit code for a failed integrity verification: the golden probe or the
# weights attestation failed, so the replica was about to serve (or was
# serving) wrong answers. Distinct from every other code because the
# supervisor's answer is a cold restart: a warm one would restore the very
# state that just failed.
INTEGRITY_EXIT_CODE = 86

# Process-start anchor for time_to_ready_s. Module import happens at the top
# of server bootstrap, so this slightly undercounts interpreter start — the
# compile/warmup cost it exists to expose dwarfs that.
_PROCESS_START = time.monotonic()


def pool_from_env() -> Optional[str]:
    """The fleet pool label this replica was spawned into, or None."""
    return os.environ.get(POOL_ENV, "").strip() or None


def restarts_from_env() -> int:
    """How many times the supervisor has restarted this replica (0 on the
    first launch or outside a supervisor)."""
    raw = os.environ.get(RESTARTS_ENV, "").strip()
    try:
        return max(0, int(raw)) if raw else 0
    except ValueError:
        return 0


class StartupTracker:
    """`loading -> warming -> verifying -> ready` behind /startupz.

    A k8s startupProbe polls /startupz with a generous failureThreshold;
    readiness/liveness probes only take over once startup has succeeded, so
    a cold compile cache cannot get the pod killed mid-warmup.
    """

    def __init__(self) -> None:
        self._state = LOADING
        self._since = time.monotonic()
        self.time_to_ready_s: Optional[float] = None
        self.error: Optional[str] = None

    @property
    def state(self) -> str:
        return self._state

    @property
    def ready(self) -> bool:
        return self._state == READY

    def mark(self, state: str) -> None:
        if state not in (LOADING, WARMING, VERIFYING, READY):
            raise ValueError(f"unknown startup state {state!r}")
        self._state = state
        self._since = time.monotonic()

    def mark_ready(self, metrics=None) -> float:
        """Transition to ready; record time_to_ready_s (process start ->
        now) into `metrics` when given. Returns the gauge value."""
        self._state = READY
        self._since = time.monotonic()
        self.time_to_ready_s = time.monotonic() - _PROCESS_START
        if metrics is not None:
            metrics.set_time_to_ready(self.time_to_ready_s)
        return self.time_to_ready_s

    def mark_failed(self, error: str) -> None:
        """Terminal: bring-up raised. /startupz keeps answering 503 with the
        error for whatever probe window remains before the process exits."""
        self._state = FAILED
        self._since = time.monotonic()
        self.error = error

    def snapshot(self) -> dict:
        # a replica that is still loading already declares which build is
        # coming up
        from spotter_tpu_torch.engine.metrics import default_build_version

        return {
            "state": self._state,
            "ready": self.ready,
            "state_age_s": time.monotonic() - self._since,
            "time_to_ready_s": self.time_to_ready_s,
            "error": self.error,
            "pool": pool_from_env(),
            "version": default_build_version(),
        }


class PreemptionWatcher:
    """Watch for preemption (SIGTERM or a maintenance-event source) and run
    one graceful drain-then-exit sequence.

    `on_preempt` is awaited exactly once (typically `detector.drain()` — it
    already flips readiness so the LB stops routing); then `exit_cb` is
    called with `PREEMPTED_EXIT_CODE`. Tests inject a no-op `exit_cb`; the
    server default is `os._exit`, which is deliberate: after a drain there is
    nothing left worth unwinding, and a preempted host may have seconds.
    """

    def __init__(
        self,
        on_preempt: Callable[[], Awaitable],
        poll_s: Optional[float] = None,
        file_source: Optional[str] = None,
        url_source: Optional[str] = None,
        exit_cb: Callable[[int], None] = os._exit,
        install_sigterm: bool = True,
    ) -> None:
        if poll_s is None:
            raw = os.environ.get(PREEMPTION_POLL_ENV, "").strip()
            poll_s = float(raw) if raw else DEFAULT_PREEMPTION_POLL_S
        self.on_preempt = on_preempt
        self.poll_s = max(poll_s, 0.01)
        self.file_source = (
            file_source
            if file_source is not None
            else os.environ.get(PREEMPTION_FILE_ENV, "").strip() or None
        )
        self.url_source = (
            url_source
            if url_source is not None
            else os.environ.get(PREEMPTION_URL_ENV, "").strip() or None
        )
        self.exit_cb = exit_cb
        self.install_sigterm = install_sigterm
        self.preempted = False
        self.reason: Optional[str] = None
        self._task: Optional[asyncio.Task] = None
        self._triggered = asyncio.Event()

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        if self.install_sigterm:
            try:
                loop.add_signal_handler(
                    signal.SIGTERM, self.trigger, "SIGTERM (kubelet/preemption)"
                )
            except (NotImplementedError, RuntimeError):  # non-main thread
                logger.warning("could not install SIGTERM handler")
        self._task = asyncio.create_task(self._run())

    def trigger(self, reason: str) -> None:
        """Idempotent: the first trigger wins; later ones are logged only."""
        if self.preempted:
            logger.info("preemption re-signaled (%s); drain already running", reason)
            return
        self.preempted = True
        self.reason = reason
        self._triggered.set()

    async def _check_sources(self) -> Optional[str]:
        if self.file_source and os.path.exists(self.file_source):
            return f"maintenance file {self.file_source}"
        if self.url_source:
            try:
                import httpx

                async with httpx.AsyncClient(timeout=2.0) as client:
                    resp = await client.get(self.url_source)
                body = resp.text.strip().upper()
                if resp.status_code == 200 and body not in ("", "NONE", "FALSE"):
                    return f"maintenance event from {self.url_source}: {body[:80]}"
            except Exception:  # metadata endpoint flaky — never a crash source
                logger.debug("preemption URL poll failed", exc_info=True)
        return None

    async def _run(self) -> None:
        while not self._triggered.is_set():
            reason = await self._check_sources()
            if reason is not None:
                self.trigger(reason)
                break
            try:
                await asyncio.wait_for(self._triggered.wait(), self.poll_s)
            except asyncio.TimeoutError:
                continue
        await self._triggered.wait()
        logger.warning("preemption: %s — draining then exiting %d",
                       self.reason, PREEMPTED_EXIT_CODE)
        try:
            await self.on_preempt()
        except Exception:
            logger.exception("drain during preemption failed; exiting anyway")
        # the trace ring dies with the process: persist it, so what was in
        # flight when the preemption landed is answerable after the restart
        from spotter_tpu_torch.obs.recorder import dump_for_exit

        dump_for_exit(PREEMPTED_EXIT_CODE)
        self.exit_cb(PREEMPTED_EXIT_CODE)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
