"""Standalone aiohttp serving runtime of the port (port of
spotter_tpu.serving.standalone).

Routes:
- `POST /detect`: {"image_urls": [...]} -> the reference wire schema,
  plus optional free-text `queries` for the open-vocabulary families
  (OWL-ViT, OWLv2), which then label the detections; 429 (queue full,
  admission limit) or 503 (breaker open, draining, brownout bulk shed) with
  Retry-After when the whole request is shed; 400 for a bad body, a
  pydantic-invalid request, or `queries` sent to a closed-set model;
- `GET /startupz`: the `loading -> warming -> ready` state (503 until ready);
- `GET /healthz`: readiness (503 while starting, breaker open or draining);
- `GET /livez`: liveness;
- `POST /drain`: stop admitting, flush, wait for in-flight batches (body
  `{"deadline_ms": N}` caps the wait); guarded by `X-Admin-Token` when
  `SPOTTER_TPU_ADMIN_TOKEN` is set;
- `GET /metrics`: the engine's metrics snapshot as JSON.

The HTTP surface binds before the model loads: bring-up runs as a
background task, and a failed bring-up exits `BRINGUP_FAILED_EXIT_CODE`. A
fatal device error exits `FATAL_ENGINE_EXIT_CODE` (85); a preemption
(SIGTERM or `SPOTTER_TPU_PREEMPTION_FILE`) drains and exits 83.

    MODEL_NAME=PekingU/rtdetr_v2_r101vd python -m spotter_tpu_torch.serving.standalone \\
        [--port 8000] [--device cpu] [--no-warmup]

MODEL_NAME picks the family: RT-DETR (`PekingU/rtdetr_v2_*`), YOLOS
(`hustvl/yolos-base`), OWL-ViT (`google/owlvit-base-patch32`, `-patch16`)
or OWLv2 (`google/owlv2-base-patch16-ensemble`). The OWL families read
their prompts' token ids from `$SPOTTER_TPU_CACHE/<model>--v3/tokenized.json`
(convert/tokens.py). `SPOTTER_TPU_TINY=1` serves the family's tiny
config (random weights) for smoke runs. The model runs on `cuda` unless
`--device cpu` is given; with no GPU it raises. Tenancy, the result cache,
output integrity, `/profile`, `/debug/*` and the stub engine are not
ported yet: `make_app` refuses the first three's knobs
(`app.refuse_unported_planes`), and `/healthz` reports `"integrity": "off"`.
"""

import argparse
import asyncio
import json
import logging
import math
import os

import pydantic
from aiohttp import web

from spotter_tpu_torch.serving import lifecycle
from spotter_tpu_torch.serving.detector import QueriesUnsupportedError
from spotter_tpu_torch.serving.overload import BULK, SLO
from spotter_tpu_torch.serving.resilience import AdmissionError

logger = logging.getLogger(__name__)

ADMIN_TOKEN_ENV = "SPOTTER_TPU_ADMIN_TOKEN"
ADMIN_TOKEN_HEADER = "X-Admin-Token"
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


def _admin_rejection(request: web.Request) -> web.Response | None:
    """401 when SPOTTER_TPU_ADMIN_TOKEN is set and the request lacks it."""
    token = os.environ.get(ADMIN_TOKEN_ENV, "")
    if not token or request.headers.get(ADMIN_TOKEN_HEADER, "") == token:
        return None
    return web.json_response(
        {"error": f"admin endpoint requires {ADMIN_TOKEN_HEADER}", "status": 401}, status=401
    )


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


def make_app(
    detector=None,
    model_name: str | None = None,
    warmup: bool = False,
    preemption: bool = False,
    device: str | None = None,
    bringup_exit_cb=os._exit,
    fatal_exit_cb=os._exit,
) -> web.Application:
    """Build the serving app.

    With `detector` given (tests, or a caller that built it), the app is
    ready at once. Otherwise bring-up (`build_detector_app(model_name,
    device=device)`) runs as a background task after the HTTP surface binds,
    and a failure calls `bringup_exit_cb(BRINGUP_FAILED_EXIT_CODE)`. The
    batcher gets `fatal_exit_cb` for fatal device errors. `preemption=True`
    (the `main()` path) installs the PreemptionWatcher. Raises at once when
    a knob of an unported serving plane is set (`refuse_unported_planes`).
    """
    from spotter_tpu_torch.serving.app import refuse_unported_planes

    refuse_unported_planes()
    app = web.Application(client_max_size=64 * 1024 * 1024)
    tracker = lifecycle.StartupTracker()
    app["startup"] = tracker
    app["detector"] = detector

    def _wire(det) -> None:
        det.engine.metrics.set_restarts(lifecycle.restarts_from_env())
        model = model_name or os.environ.get("MODEL_NAME") or det.engine.built.model_name
        det.engine.metrics.set_identity(model=model)
        if det.batcher.fatal_exit_cb is None:
            det.batcher.fatal_exit_cb = fatal_exit_cb

    if detector is not None:
        _wire(detector)
        tracker.mark_ready(detector.engine.metrics)

    async def _bring_up(app: web.Application) -> None:
        from spotter_tpu_torch.serving.app import build_detector_app

        loop = asyncio.get_running_loop()
        try:
            det = await loop.run_in_executor(
                None, lambda: build_detector_app(model_name, device=device)
            )
            tracker.mark(lifecycle.WARMING)
            if warmup:
                await loop.run_in_executor(None, det.engine.warmup)
            _wire(det)
            app["detector"] = det
            logger.info("replica ready in %.1f s", tracker.mark_ready(det.engine.metrics))
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
        det = request.app["detector"]
        if det is None:  # still loading/warming: shed, probe /startupz
            return _not_ready_response(tracker)
        shed = det.check_admission()
        if shed is not None:  # draining / breaker open: reject before parsing
            return _shed_response(shed)
        try:
            payload = await request.json()
        except json.JSONDecodeError:
            return web.Response(status=400, text="Invalid JSON body")
        cls, payload = classify_request(request.headers, payload)
        shed = det.check_admission(cls)
        if shed is not None:  # brownout bulk shed: reject before fetching
            return _shed_response(shed)
        try:
            response = await det.detect(payload, cls=cls)
        except pydantic.ValidationError as exc:
            return web.Response(status=400, text=f"Invalid request: {exc}")
        except QueriesUnsupportedError as exc:
            return web.Response(status=400, text=str(exc))
        except AdmissionError as exc:  # every image shed -> 429/503
            return _shed_response(exc)
        except Exception:
            logger.exception("detect failed")
            return web.Response(status=500, text="Internal server error")
        return web.json_response(response.model_dump(exclude_none=True))

    async def startupz(request: web.Request) -> web.Response:
        return web.json_response(tracker.snapshot(), status=200 if tracker.ready else 503)

    async def healthz(request: web.Request) -> web.Response:
        det = request.app["detector"]
        if det is None:
            return _not_ready_response(tracker)
        health = det.health()
        health["startup"] = tracker.state
        health["pool"] = lifecycle.pool_from_env()
        health["integrity"] = "off"  # the plane is not ported (ROADMAP Queue 1 item 6)
        return web.json_response(health, status=200 if health["ready"] else 503)

    async def livez(request: web.Request) -> web.Response:
        return web.json_response({"status": "alive"})

    async def drain(request: web.Request) -> web.Response:
        rejected = _admin_rejection(request)
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
            return web.json_response({"startup": tracker.snapshot()})
        return web.json_response(det.engine.metrics.snapshot())

    async def on_cleanup(app: web.Application) -> None:
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
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    web.run_app(
        make_app(model_name=args.model, warmup=not args.no_warmup, preemption=True,
                 device=args.device),
        host=args.host,
        port=args.port,
    )


if __name__ == "__main__":
    main()
