"""Standalone aiohttp serving runtime of the port (port of
spotter_tpu.serving.standalone).

Routes:
- `POST /detect`: {"image_urls": [...]} -> the reference wire schema,
  plus optional free-text `queries` for the open-vocabulary families
  (OWL-ViT, OWLv2), which then label the detections; 429 (queue full,
  admission limit) or 503 (breaker open, draining, brownout bulk shed) with
  Retry-After when the whole request is shed; 400 for a bad body, a
  pydantic-invalid request, or `queries` sent to a closed-set model;
- `GET /startupz`: the `loading -> warming -> verifying -> ready` state
  (503 until ready);
- `GET /healthz`: readiness (503 until ready, and while the breaker is
  open or a drain runs);
- `GET /livez`: liveness;
- `POST /drain`: stop admitting, flush, wait for in-flight batches (body
  `{"deadline_ms": N}` caps the wait);
- `GET /metrics`: the engine's metrics snapshot with the integrity plane's,
  as JSON, or as Prometheus text behind `?format=prometheus` or
  `Accept: text/plain`;
- `POST /profile`: a `torch.profiler` capture of in-flight device work
  (body `{"duration_s": x}`, at most 30 s), into a directory the server
  picks (`SPOTTER_TPU_PROFILE_DIR` or the system temp dir);
- `GET /debug/traces` (the flight recorder; `?request_id=` or `?trace_id=`
  for one request), `GET /debug/perf` (the device-efficiency ledger) and
  `GET /debug/tenants` (the full per-tenant table).

The admin endpoints (/drain, /profile, /debug/*) require `X-Admin-Token`
when `SPOTTER_TPU_ADMIN_TOKEN` is set. Every /detect response carries its
`X-Request-ID` (the client's, or minted) and `traceparent`, and a traced
one its per-stage `Server-Timing`; the trace lands in the flight recorder
(`SPOTTER_TPU_TRACE_RING`). `SPOTTER_TPU_LOG_JSON=1` makes the logs JSON
lines carrying the trace id. Once a detector is up, every /detect outcome
carries `X-Spotter-Replica` and `X-Spotter-Version`.

The replica planes (each absent, and /detect's JSON byte-identical, when
its knobs are unset):
- tenancy (serving/tenancy.py: `SPOTTER_TPU_TENANT_CONFIG`, `_TENANT_KEYS`,
  `_TENANT_RPS_DEFAULT`): once READY, a request's tenant is resolved and
  charged before any parse, fetch or decode; an over-quota tenant gets 429
  with a tenant-scoped Retry-After, and its slot is released exactly once
  however the request ends (a client disconnect included); /metrics gains
  a bounded `tenants` view;
- the result cache (`--cache-mb` or `SPOTTER_TPU_CACHE_MAX_MB`): URL
  single-flight, the negative cache and keyed coalescing
  (serving/detector.py); each /detect answers `X-Cache` and, for
  deterministic failures, `X-Spotter-Negative`;
- the binary wire format: `Accept: application/x-spotter-frame` gets the
  response as an SPTF frame (serving/wire.py);
- the stub engine (`--stub-engine` or `SPOTTER_TPU_STUB_ENGINE=1`; canned
  detections, no device; never production);
- ragged packing (`--ragged` or `SPOTTER_TPU_RAGGED=1`): the batcher's
  scheduler orders by deadline slack and, for a shortest-edge family
  (Deformable-DETR, the DETR lineage), packs mixed-size photos into one
  snapped canvas (engine/scheduler.py); /healthz reports `ragged: true` and
  /metrics `padding_waste_pct` and `ragged_packs_total`.

The HTTP surface binds before the model loads: bring-up runs as a
background task, and a failed bring-up exits `BRINGUP_FAILED_EXIT_CODE`.
With the output-integrity plane on (`SPOTTER_TPU_INTEGRITY`, default on),
the replica passes the `verifying` gate before it serves: on-device
attestation and the golden probe through the real batcher
(serving/integrity.py); a failure there, or in the periodic
re-verification after, exits `INTEGRITY_EXIT_CODE` (86). A fatal device
error exits `FATAL_ENGINE_EXIT_CODE` (85); a preemption (SIGTERM or
`SPOTTER_TPU_PREEMPTION_FILE`) drains and exits 83. `SPOTTER_TPU_FAULTS`
arms the fault injection (testing/faults.py) for chaos staging.

    MODEL_NAME=PekingU/rtdetr_v2_r101vd python -m spotter_tpu_torch.serving.standalone \\
        [--port 8000] [--device cpu] [--no-warmup] [--decode-workers N] [--cache-mb MB] \\
        [--ragged] [--stub-engine]

MODEL_NAME picks the family: RT-DETR (`PekingU/rtdetr_v2_*`), YOLOS
(`hustvl/yolos-base`), OWL-ViT (`google/owlvit-base-patch32`, `-patch16`)
or OWLv2 (`google/owlv2-base-patch16-ensemble`). The OWL families read
their prompts' token ids from `$SPOTTER_TPU_CACHE/<model>--v3/tokenized.json`
(convert/tokens.py). `SPOTTER_TPU_TINY=1` serves the family's tiny
config (random weights) for smoke runs. The model runs on `cuda` unless
`--device cpu` is given; with no GPU it raises. Warmup captures each
bucket's CUDA graph before the replica verifies; the identity block of
/metrics carries the engine's `weights_digest()` (or
SPOTTER_TPU_WEIGHTS_DIGEST when set).
"""

import argparse
import asyncio
import json
import logging
import math
import os
import tempfile

import pydantic
from aiohttp import web

from spotter_tpu_torch.engine.metrics import default_weights_digest
from spotter_tpu_torch.obs import http as obs_http
from spotter_tpu_torch.obs import logs as obs_logs
from spotter_tpu_torch.ops.preprocess import DECODE_WORKERS_ENV
from spotter_tpu_torch.serving import integrity, lifecycle, tenancy, wire
from spotter_tpu_torch.serving.detector import QueriesUnsupportedError
from spotter_tpu_torch.serving.overload import BULK, SLO
from spotter_tpu_torch.serving.resilience import AdmissionError
from spotter_tpu_torch.serving.tenancy import TenantQuotaError
from spotter_tpu_torch.testing import faults, stub_engine

logger = logging.getLogger(__name__)

REQUEST_CLASS_HEADER = "X-Request-Class"
REQUEST_CLASS_KEY = "request_class"


def classify_request(headers, payload) -> tuple[str, object]:
    """(request class, payload without the class key). Precedence: the
    X-Request-Class header, then a `request_class` payload key, then "slo"
    (unclassified traffic is treated as latency-critical)."""
    cls = str(headers.get(REQUEST_CLASS_HEADER, "")).strip().lower()
    if isinstance(payload, dict):
        if not cls:
            cls = str(payload.get(REQUEST_CLASS_KEY, "")).strip().lower()
        payload = {k: v for k, v in payload.items() if k != REQUEST_CLASS_KEY}
    return (cls if cls in (SLO, BULK) else SLO), payload


def _rmdir_quiet(path: str) -> None:
    """Drop a just-created empty trace dir on a failed /profile request."""
    try:
        os.rmdir(path)
    except OSError:  # not empty (trace partly written) or already gone
        pass


def _shed_response(exc: AdmissionError) -> web.Response:
    # Retry-After never renders 0: a sub-second hint ceils to 1, and the
    # precise float rides in the body
    return web.json_response(
        {
            "error": str(exc),
            "status": exc.status,
            "retry_after_s": round(max(exc.retry_after_s, 0.0), 3),
        },
        status=exc.status,
        headers={"Retry-After": f"{max(1, math.ceil(exc.retry_after_s))}"},
    )


def _not_ready_response(tracker: lifecycle.StartupTracker) -> web.Response:
    return web.json_response(
        {"error": f"replica starting up ({tracker.state})", "status": 503},
        status=503,
        headers={"Retry-After": "2"},
    )


def _build_detector_blocking(model_name: str | None, device: str | None):
    """The heavy half of bring-up, run in an executor: the stub detector
    when stub mode is on, else the model's."""
    if stub_engine.stub_mode_enabled():
        logger.warning(
            "STUB ENGINE ACTIVE (%s): canned detections, no device; never production",
            stub_engine.STUB_ENGINE_ENV,
        )
        return stub_engine.build_stub_detector()
    from spotter_tpu_torch.serving.app import build_detector_app

    return build_detector_app(model_name, device=device)


def make_app(
    detector=None,
    model_name: str | None = None,
    warmup: bool = False,
    preemption: bool = False,
    device: str | None = None,
    bringup_exit_cb=os._exit,
    fatal_exit_cb=os._exit,
    integrity_exit_cb=os._exit,
) -> web.Application:
    """Build the serving app.

    With `detector` given (tests, or a caller that built it), the app is
    ready at once and skips verification, as it skips bring-up. Otherwise
    bring-up (`build_detector_app(model_name, device=device)`) runs as a
    background task after the HTTP surface binds, and a failure calls
    `bringup_exit_cb(BRINGUP_FAILED_EXIT_CODE)`. With the integrity plane on,
    bring-up then passes the `verifying` gate (after the `corrupt_weights`
    fault seam): attestation and the golden probe must pass before READY,
    or `integrity_exit_cb(INTEGRITY_EXIT_CODE)` is called; after READY the
    plane re-verifies on its periods. The replica answers /detect and
    /healthz only once READY. The batcher gets `fatal_exit_cb` for fatal
    device errors. `preemption=True` (the `main()` path) installs the
    PreemptionWatcher. The tenancy plane comes from its env knobs
    (`tenancy.from_env`, None when unconfigured) and is attached to the
    detector either way; with SPOTTER_TPU_STUB_ENGINE on, bring-up builds the
    stub detector. Raises at once when a knob of an unported serving plane
    is set (`refuse_unported_planes`), and arms SPOTTER_TPU_FAULTS.
    """
    from spotter_tpu_torch.serving.app import refuse_unported_planes

    refuse_unported_planes()
    app = web.Application(client_max_size=64 * 1024 * 1024)
    tracker = lifecycle.StartupTracker()
    app["startup"] = tracker
    app["detector"] = detector
    # the tenant isolation plane: None unless configured, and then every
    # tenant branch below is absent
    tenant_plane = tenancy.from_env()
    app["tenancy"] = tenant_plane
    if faults.maybe_activate_from_env() is not None:
        logger.warning(
            "FAULT INJECTION ACTIVE (%s): this server is a chaos target, never production",
            faults.FAULTS_ENV,
        )

    def _wire(det) -> None:
        det.engine.metrics.set_restarts(lifecycle.restarts_from_env())
        built = getattr(det.engine, "built", None)
        model = (model_name or os.environ.get("MODEL_NAME")
                 or getattr(built, "model_name", None) or "stub")
        det.engine.metrics.set_identity(model=model)
        # an operator-pinned SPOTTER_TPU_WEIGHTS_DIGEST (stamped at Metrics
        # init) outranks the engine's computed one
        if default_weights_digest() is None:
            det.engine.metrics.set_identity(weights_digest=det.engine.weights_digest())
        if det.batcher.fatal_exit_cb is None:
            det.batcher.fatal_exit_cb = fatal_exit_cb
        det.attach_tenancy(tenant_plane)

    if detector is not None:
        _wire(detector)
        tracker.mark_ready(detector.engine.metrics)

    async def _bring_up(app: web.Application) -> None:
        loop = asyncio.get_running_loop()
        try:
            det = await loop.run_in_executor(None, _build_detector_blocking, model_name, device)
            tracker.mark(lifecycle.WARMING)
            if warmup:
                await loop.run_in_executor(None, det.engine.warmup)
            app["detector"] = det
            _wire(det)
            # fault seam (chaos only): corrupt the live weights after load and
            # before verification, the flipped-bit-after-restore shape the
            # attestation gate must catch
            n_corrupt = faults.take_corrupt_weights()
            if n_corrupt:
                logger.warning("FAULT: corrupting %d weight leaves before verification",
                               n_corrupt)
                det.engine.corrupt_weights(n_corrupt)
            plane = None
            if integrity.integrity_enabled():
                tracker.mark(lifecycle.VERIFYING)
                plane = integrity.IntegrityPlane(
                    det.engine, det.batcher, exit_cb=integrity_exit_cb)
                app["integrity"] = plane
                source = "warm-restore" if lifecycle.restarts_from_env() > 0 else "cold-start"
                if not await plane.verify(source):
                    tracker.mark_failed(plane.last_error or "integrity")
                    plane.integrity_exit(plane.last_error or source)
                    return
            logger.info("replica ready in %.1f s", tracker.mark_ready(det.engine.metrics))
            if plane is not None:
                await plane.start()
        except asyncio.CancelledError:  # server shutdown mid-bring-up
            raise
        except Exception as exc:
            logger.exception(
                "replica bring-up failed; exiting %d", lifecycle.BRINGUP_FAILED_EXIT_CODE
            )
            tracker.mark_failed(f"{type(exc).__name__}: {exc}")
            bringup_exit_cb(lifecycle.BRINGUP_FAILED_EXIT_CODE)

    async def on_startup(app: web.Application) -> None:
        if app["detector"] is None:
            app["bringup_task"] = asyncio.create_task(_bring_up(app))
        if preemption:
            async def drain_on_preempt():
                det = app["detector"]
                if det is not None:
                    await det.drain()

            watcher = lifecycle.PreemptionWatcher(drain_on_preempt)
            app["preemption_watcher"] = watcher
            await watcher.start()

    async def detect(request: web.Request) -> web.Response:
        # the request's trace: continue the caller's traceparent or mint ids
        # from (or with) X-Request-ID; every branch below echoes the request
        # id, and the completed trace lands in the flight recorder with its
        # per-stage Server-Timing on the response
        trace, request_id = obs_http.begin_http_trace(request)
        tadm = None

        def done(resp: web.Response) -> web.Response:
            # the tenant's slot is released once with the outcome: sheds and
            # server errors burn its SLO budget, everything else credits it
            if tadm is not None:
                tadm.release(good=resp.status not in (429, 503) and resp.status < 500)
            # which replica and build answered, on every outcome
            if det is not None:
                resp.headers[wire.REPLICA_HEADER] = det.engine.metrics.replica_id
                resp.headers[wire.VERSION_HEADER] = det.engine.metrics.version
            return obs_http.finish_http_trace(trace, request_id, resp, server_timing=True)

        det = request.app["detector"]
        if det is None or not tracker.ready:  # loading, warming, verifying or failed
            return done(_not_ready_response(tracker))
        if faults.take_flaky(det.engine.metrics.replica_id):
            # injected intermittent failure (chaos only)
            return done(web.json_response(
                {"error": "injected flaky failure", "status": 500}, status=500))
        tenant = None
        if tenant_plane is not None:
            # charge the tenant's bucket and inflight cap before any parse,
            # fetch or decode: an over-quota tenant sheds 429 here
            tenant = tenant_plane.resolve(request.headers)
            try:
                tadm = tenant_plane.try_admit(tenant)
            except TenantQuotaError as exc:
                det.engine.metrics.record_shed()
                det.engine.metrics.record_admit_shed(classify_request(request.headers, None)[0])
                return done(_shed_response(exc))
        try:
            shed = det.check_admission()
            if shed is not None:  # draining / breaker open: reject before parsing
                return done(_shed_response(shed))
            try:
                payload = await request.json()
            except json.JSONDecodeError:
                return done(web.Response(status=400, text="Invalid JSON body"))
            cls, payload = classify_request(request.headers, payload)
            shed = det.check_admission(cls, tenant)
            if shed is not None:  # brownout bulk shed: reject before fetching
                return done(_shed_response(shed))
            # per-URL cache outcomes (X-Cache) and verdicts (X-Spotter-Negative)
            info: dict = {}
            try:
                response = await det.detect(payload, cls=cls, info=info, tenant=tenant)
            except pydantic.ValidationError as exc:
                return done(web.Response(status=400, text=f"Invalid request: {exc}"))
            except QueriesUnsupportedError as exc:
                return done(web.Response(status=400, text=str(exc)))
            except AdmissionError as exc:  # every image shed -> 429/503
                return done(_shed_response(exc))
            except Exception:
                logger.exception("detect failed")
                return done(web.Response(status=500, text="Internal server error"))
            body = response.model_dump(exclude_none=True)
            # `Accept: application/x-spotter-frame` negotiates the binary
            # frame; otherwise the plain JSON response, byte-identical
            frame = wire.wants_frame(request.headers.get("Accept"))
            if frame:
                # corrupt_frame (chaos only) flips a byte after the CRCs
                resp = web.Response(
                    body=faults.corrupt_frame_bytes(wire.encode_frame(body),
                                                    det.engine.metrics.replica_id),
                    content_type=wire.FRAME_CONTENT_TYPE,
                )
            else:
                resp = web.json_response(body)
            x_cache = wire.summarize_cache_outcomes((info.get("cache") or {}).values())
            if x_cache is not None:
                resp.headers[wire.X_CACHE_HEADER] = x_cache
            verdicts = wire.encode_negative_header(info.get("negative") or {})
            if verdicts is not None:
                resp.headers[wire.NEGATIVE_HEADER] = verdicts
            out_bytes = resp.body
            det.engine.metrics.record_wire(
                request.content_length or 0,
                len(out_bytes) if isinstance(out_bytes, (bytes, bytearray)) else 0,
                frame,
            )
            return done(resp)
        finally:
            # a client disconnect (CancelledError at any await) or an
            # uncaught error must still free the tenant's slot; after done()
            # this is a no-op, and it never touches the SLO burn
            if tadm is not None:
                tadm.release(good=None)

    async def startupz(request: web.Request) -> web.Response:
        return web.json_response(tracker.snapshot(), status=200 if tracker.ready else 503)

    async def healthz(request: web.Request) -> web.Response:
        det = request.app["detector"]
        if det is None or not tracker.ready:
            return _not_ready_response(tracker)
        health = det.health()
        health["startup"] = tracker.state
        health["pool"] = lifecycle.pool_from_env()
        return web.json_response(health, status=200 if health["ready"] else 503)

    async def livez(request: web.Request) -> web.Response:
        return web.json_response({"status": "alive"})

    async def drain(request: web.Request) -> web.Response:
        rejected = obs_http.admin_rejection(request)
        if rejected is not None:
            return rejected
        det = request.app["detector"]
        if det is None:
            return _not_ready_response(tracker)
        try:
            body = await request.json()
        except json.JSONDecodeError:
            body = {}
        timeout_s = None
        if isinstance(body, dict) and "deadline_ms" in body:
            try:
                timeout_s = max(float(body["deadline_ms"]), 0.0) / 1000.0
            except (TypeError, ValueError):
                return web.Response(status=400, text="deadline_ms must be a number")
        return web.json_response(await det.drain(timeout_s))

    async def metrics(request: web.Request) -> web.Response:
        det = request.app["detector"]
        if det is None:
            return obs_http.metrics_response(request, {"startup": tracker.snapshot()})
        snap = det.engine.metrics.snapshot()
        # the integrity plane's verification, probe and attest counters
        plane = request.app.get("integrity")
        if plane is not None:
            snap["integrity"] = plane.snapshot()
        # the bounded top-K per-tenant view; absent when unconfigured
        if tenant_plane is not None:
            snap["tenants"] = tenant_plane.metrics_view()
        return obs_http.metrics_response(request, snap)

    async def debug_tenants(request: web.Request) -> web.Response:
        """The full per-tenant table, admin-gated like /profile."""
        rejected = obs_http.admin_rejection(request)
        if rejected is not None:
            return rejected
        if tenant_plane is None:
            return web.json_response({"enabled": False})
        return web.json_response(tenant_plane.snapshot())

    async def profile(request: web.Request) -> web.Response:
        """A torch.profiler capture of in-flight device work, into a
        directory the server picks (never a client-supplied path)."""
        rejected = obs_http.admin_rejection(request)
        if rejected is not None:
            return rejected
        from spotter_tpu_torch.engine import profiler

        try:
            body = await request.json()
        except json.JSONDecodeError:
            body = {}
        if not isinstance(body, dict):
            return web.Response(status=400, text="body must be a JSON object")
        try:
            duration_s = min(float(body.get("duration_s", 1.0)), 30.0)
        except (TypeError, ValueError):
            return web.Response(status=400, text="duration_s must be a number")
        if not duration_s > 0.0:  # also rejects NaN before any dir is made
            return web.Response(status=400, text="duration_s must be > 0")
        base = os.environ.get("SPOTTER_TPU_PROFILE_DIR")
        log_dir = tempfile.mkdtemp(prefix="spotter-trace-", dir=base or None)
        try:
            summary = await asyncio.get_running_loop().run_in_executor(
                None, profiler.capture, log_dir, duration_s)
        except ValueError as exc:  # bad duration
            _rmdir_quiet(log_dir)
            return web.Response(status=400, text=str(exc))
        except RuntimeError as exc:  # a capture is already running
            _rmdir_quiet(log_dir)
            return web.Response(status=409, text=str(exc))
        return web.json_response(summary)

    async def on_cleanup(app: web.Application) -> None:
        plane = app.get("integrity")
        if plane is not None:
            await plane.aclose()
        task = app.get("bringup_task")
        if task is not None and not task.done():
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        watcher = app.get("preemption_watcher")
        if watcher is not None:
            await watcher.stop()
        if app["detector"] is not None:
            await app["detector"].aclose()

    app.router.add_post("/detect", detect)
    app.router.add_get("/startupz", startupz)
    app.router.add_get("/healthz", healthz)
    app.router.add_get("/livez", livez)
    app.router.add_post("/drain", drain)
    app.router.add_get("/metrics", metrics)
    app.router.add_post("/profile", profile)
    app.router.add_get("/debug/tenants", debug_tenants)
    app.router.add_get("/debug/traces", obs_http.make_debug_traces_handler())
    app.router.add_get("/debug/perf", obs_http.make_debug_perf_handler(
        lambda: app["detector"].engine.metrics if app["detector"] is not None else None))
    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    return app


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="spotter-tpu PyTorch/CUDA detection server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--model", default=None, help="overrides the MODEL_NAME env")
    parser.add_argument("--device", default=None,
                        help="torch device to serve on (default cuda; 'cpu' to run without a GPU)")
    parser.add_argument("--no-warmup", action="store_true")
    parser.add_argument("--decode-workers", type=int, default=None,
                        help=f"host decode/resize pool size ({DECODE_WORKERS_ENV})")
    parser.add_argument("--cache-mb", type=float, default=None,
                        help="result cache and request coalescing budget in MB "
                             "(SPOTTER_TPU_CACHE_MAX_MB; 0, the default, disables the tier)")
    parser.add_argument("--ragged", action="store_true",
                        help="ragged packing and deadline-slack scheduling (SPOTTER_TPU_RAGGED=1): "
                             "mixed-size photos of a shortest-edge family pack into one snapped "
                             "canvas; unset keeps the per-bucket FIFO")
    parser.add_argument("--stub-engine", action="store_true",
                        help=f"canned-detection stub engine ({stub_engine.STUB_ENGINE_ENV}=1); "
                             "tests only, never production")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    # SPOTTER_TPU_LOG_JSON=1: JSON log lines carrying the trace and request
    # id of whatever request was active when the line was emitted
    obs_logs.maybe_setup_json_logging()
    # the flag lands in the env: bring-up reads it there, so flag and env
    # behave identically
    if args.decode_workers is not None:
        os.environ[DECODE_WORKERS_ENV] = str(args.decode_workers)
    if args.cache_mb is not None:
        from spotter_tpu_torch.caching.result_cache import CACHE_MAX_MB_ENV

        os.environ[CACHE_MAX_MB_ENV] = str(args.cache_mb)
    if args.ragged:
        from spotter_tpu_torch.engine.scheduler import RAGGED_ENV

        os.environ[RAGGED_ENV] = "1"
    if args.stub_engine:
        os.environ[stub_engine.STUB_ENGINE_ENV] = "1"
    web.run_app(
        make_app(model_name=args.model, warmup=not args.no_warmup, preemption=True,
                 device=args.device),
        host=args.host,
        port=args.port,
    )


if __name__ == "__main__":
    main()
