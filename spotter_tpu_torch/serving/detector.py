"""AmenitiesDetector: fetch -> decode -> detect -> draw -> encode, with
per-image error containment (port of spotter_tpu.serving.detector).

The behaviour contract with the reference detector (serve.py:64-196), as
the JAX package keeps it at the /detect wire:
- URL fetch with retry: 3 attempts, exponential backoff in [4, 10] s;
  deterministic 4xx statuses (other than 408/429) and size-cap rejections
  are not retried. Fetches are bounded in time (`SPOTTER_TPU_FETCH_TIMEOUT_S`)
  and bytes (`SPOTTER_TPU_FETCH_MAX_BYTES`: content-length reject plus a
  streamed read cap);
- PIL open, the decode-bomb guard (`check_image_pixels`), convert("RGB");
- detections filtered through AMENITIES_MAPPING, other labels dropped
  (a request's own `queries` label its detections directly);
- red box width 3, amenity text at (x+5, y+5), white fill, black stroke;
  JPEG + base64 of the annotated image as `labeled_image_base64`;
- httpx errors -> "HTTP Error: ...", fetch failures -> "Fetch Error: ...",
  anything else -> "Processing Error: ..." with the traceback; one bad URL
  never fails the request;
- "The property contains: ..." / "No relevant amenities detected.".

Detection goes through the MicroBatcher into the engine. An optional
per-request `Deadline` (`SPOTTER_TPU_REQUEST_DEADLINE_MS`) bounds fetch,
queue wait and the device call. Admission rejections stay per-image errors
when a request is partly served; a fully shed request re-raises so the HTTP
layer answers 429/503 with Retry-After. The brownout threshold rung raises
the detection bar when the overload tier is armed.

Open-vocabulary families (OWL-ViT, OWLv2) take a request's free-text
`queries`: the detector resolves them once per request through the
memoized `TextQueryResolver` (caching/text_cache.py), in an executor so a
text-tower encode never blocks the event loop, and every image of the
request runs against that query set. A closed-set family answers 400.

Each image's fetch, decode and postprocess (draw and encode) are spans of
the ambient request trace (obs/trace.py); the fetch goes through the fault
seam `faults.on_fetch` first.

Not ported yet: the result cache, single-flight fetch coalescing and
tenancy.
"""

import asyncio
import base64
import traceback
from io import BytesIO

import httpx
from PIL import Image, ImageDraw

from spotter_tpu_torch import obs
from spotter_tpu_torch.caching.text_cache import TextQueryResolver
from spotter_tpu_torch.engine.batcher import MicroBatcher
from spotter_tpu_torch.ops.preprocess import check_image_pixels
from spotter_tpu_torch.schemas import (
    DetectionErrorResult,
    DetectionRequest,
    DetectionResponse,
    DetectionResult,
    DetectionSuccessResult,
    ImageResult,
)
from spotter_tpu_torch.serving.overload import BULK, BrownoutShedError
from spotter_tpu_torch.serving.resilience import (
    AdmissionError,
    CircuitBreaker,
    CircuitOpenError,
    Deadline,
    DeadlineExceededError,
    DrainingError,
    _env_float,
    _env_int,
    jittered_retry_after,
)
from spotter_tpu_torch.taxonomy import AMENITIES_MAPPING
from spotter_tpu_torch.testing import faults

# Fetch retry policy (serve.py:84-88). Module-level so tests can zero the
# backoff instead of sleeping through it.
FETCH_RETRY_ATTEMPTS = 3
FETCH_RETRY_WAIT_MIN_S = 4.0
FETCH_RETRY_WAIT_MAX_S = 10.0

FETCH_TIMEOUT_ENV = "SPOTTER_TPU_FETCH_TIMEOUT_S"
DEFAULT_FETCH_TIMEOUT_S = 15.0
FETCH_MAX_BYTES_ENV = "SPOTTER_TPU_FETCH_MAX_BYTES"
DEFAULT_FETCH_MAX_BYTES = 32 * 1024 * 1024
# 4xx statuses that are worth retrying (timeout, rate limit); every other
# 4xx is deterministic and fails fast
RETRYABLE_4XX = (408, 429)


class QueriesUnsupportedError(ValueError):
    """A /detect carried free-text `queries`, but the served model is
    closed-set. The HTTP layer answers 400."""


class FetchError(RuntimeError):
    """Typed image-fetch failure (size cap, retries exhausted); `retryable`
    tells the retry loop whether another attempt could succeed."""

    def __init__(self, message: str, retryable: bool = False) -> None:
        super().__init__(message)
        self.retryable = retryable


def _fetch_retryable(exc: BaseException) -> bool:
    """Retry connect/timeout/5xx; never deterministic failures."""
    if isinstance(exc, FetchError):
        return exc.retryable
    if isinstance(exc, httpx.HTTPStatusError):
        code = exc.response.status_code
        if 400 <= code < 500:
            return code in RETRYABLE_4XX
    return True


# the summary sentence and the amenity filter, shared with assemble_response


def amenity_detections(raw_detections: list[dict]) -> list[dict]:
    """Engine detections -> [{"label": amenity, "box": [x0, y0, x1, y1]}],
    in the engine's order, keeping only labels the taxonomy maps."""
    out = []
    for det in raw_detections:
        amenity = AMENITIES_MAPPING.get(det["label"])
        if amenity is not None:
            out.append({"label": amenity, "box": list(det["box"])})
    return out


def amenities_description(amenities) -> str:
    """The reference's summary sentence over a set of amenity labels."""
    if not amenities:
        return "No relevant amenities detected."
    return f"The property contains: {', '.join(sorted(amenities))}."


def assemble_response(urls, raw_per_image: list[list[dict]]) -> dict:
    """Per-image engine detections -> {"amenities_description", "images"},
    as plain dicts and without the drawn image: the response shape for
    callers that hold detections rather than URLs."""
    if len(urls) != len(raw_per_image):
        raise ValueError(f"{len(urls)} urls but {len(raw_per_image)} detection lists")
    images = [
        {"url": url, "detections": amenity_detections(raw)}
        for url, raw in zip(urls, raw_per_image)
    ]
    labels = {d["label"] for img in images for d in img["detections"]}
    return {"amenities_description": amenities_description(labels), "images": images}


def draw_detections(image: Image.Image, detections: list[dict]) -> bytes:
    """The reference's annotation: red boxes, amenity text, JPEG bytes."""
    draw = ImageDraw.Draw(image)
    for det in detections:
        box = det["box"]
        draw.rectangle(box, outline="red", width=3)
        draw.text(
            xy=(box[0] + 5, box[1] + 5), text=det["label"], fill="white",
            stroke_width=1, stroke_fill="black",
        )
    buffer = BytesIO()
    image.save(buffer, format="JPEG")
    return buffer.getvalue()


class AmenitiesDetector:
    """Framework-agnostic core; the aiohttp runtime (standalone.py) wraps it."""

    def __init__(
        self,
        engine,
        batcher: MicroBatcher | None = None,
        client: httpx.AsyncClient | None = None,
    ) -> None:
        self.engine = engine
        self.batcher = batcher or MicroBatcher(engine)
        self.fetch_timeout_s = _env_float(FETCH_TIMEOUT_ENV, DEFAULT_FETCH_TIMEOUT_S)
        self.fetch_max_bytes = _env_int(FETCH_MAX_BYTES_ENV, DEFAULT_FETCH_MAX_BYTES)
        self.client = client or httpx.AsyncClient(timeout=self.fetch_timeout_s)
        self.threshold = float(getattr(engine, "threshold", 0.5))
        built = getattr(engine, "built", None)
        self.model_name = getattr(built, "model_name", None) or type(engine).__name__
        # the memoized query-set resolver of a text-conditioned family; None
        # for closed-set families, whose /detect `queries` answer 400
        text_encoder = getattr(built, "text_encoder", None)
        self.text_resolver = (
            TextQueryResolver(self.model_name, text_encoder, metrics=engine.metrics)
            if text_encoder is not None else None
        )

    def _check_fetch_size(self, url: str, nbytes: int) -> None:
        if self.fetch_max_bytes > 0 and nbytes > self.fetch_max_bytes:
            raise FetchError(
                f"image at {url} is {nbytes} bytes, over "
                f"{FETCH_MAX_BYTES_ENV}={self.fetch_max_bytes}",
                retryable=False,
            )

    async def _fetch_image_bytes(self, url: str) -> bytes:
        """Streamed fetch with the byte cap enforced as bytes arrive. A
        stand-in client (tests) keeps the plain get() contract and gets the
        size check after the fact. The fault seam may substitute the bytes
        or raise first."""
        injected = await faults.on_fetch(url)
        if injected is not None:
            return injected
        if type(self.client) is not httpx.AsyncClient:
            response = await self.client.get(url)
            response.raise_for_status()
            self._check_fetch_size(url, len(response.content))
            return response.content
        async with self.client.stream("GET", url) as response:
            response.raise_for_status()
            declared = response.headers.get("content-length")
            if declared is not None:
                try:
                    self._check_fetch_size(url, int(declared))
                except ValueError:
                    pass  # unparsable header: the read cap still applies
            chunks: list[bytes] = []
            total = 0
            async for chunk in response.aiter_bytes():
                total += len(chunk)
                self._check_fetch_size(url, total)
                chunks.append(chunk)
            return b"".join(chunks)

    async def _fetch_with_retries(self, url: str, deadline: Deadline | None = None) -> bytes:
        """3 attempts, exponential backoff in [min, max] s, re-raise the last
        failure. With a `deadline`, each attempt's timeout is clamped to the
        remaining budget and the loop stops once the budget cannot cover the
        backoff plus another attempt."""
        for attempt in range(1, FETCH_RETRY_ATTEMPTS + 1):
            attempt_timeout = self.fetch_timeout_s
            if deadline is not None:
                remaining = deadline.remaining()
                if remaining <= 0:
                    raise deadline.exceeded("image fetch")
                attempt_timeout = (
                    min(attempt_timeout, remaining) if attempt_timeout > 0 else remaining
                )
            try:
                fetch = self._fetch_image_bytes(url)
                if attempt_timeout > 0:
                    try:
                        return await asyncio.wait_for(fetch, attempt_timeout)
                    except asyncio.TimeoutError:
                        raise FetchError(
                            f"fetch attempt timed out after {attempt_timeout:.3f} s",
                            retryable=True,
                        ) from None
                return await fetch
            except Exception as exc:
                if attempt == FETCH_RETRY_ATTEMPTS or not _fetch_retryable(exc):
                    raise
                wait = min(max(float(2**attempt), FETCH_RETRY_WAIT_MIN_S), FETCH_RETRY_WAIT_MAX_S)
                if deadline is not None and deadline.remaining() <= wait:
                    raise
                await asyncio.sleep(wait)
        raise FetchError("failed to fetch image after retries")  # unreachable

    async def _process_single_image(
        self, url: str, deadline: Deadline | None = None, cls: str | None = None,
        qset=None,
    ) -> ImageResult:
        # the ambient request trace: None (recorder off, or a bare library
        # call) makes every span below a no-op
        trace = obs.current_trace()
        brownout = self.batcher.brownout
        # brownout threshold rung: read once, up front, for the whole image
        boost = brownout.threshold_boost_value() if brownout is not None else 0.0
        try:
            with obs.span(obs.FETCH, trace):
                fetch = self._fetch_with_retries(url, deadline)
                if deadline is not None:
                    image_bytes = await deadline.wait_for(fetch, "image fetch")
                else:
                    image_bytes = await fetch
            with obs.span(obs.DECODE, trace), Image.open(BytesIO(image_bytes)) as img_raw:
                # decode-bomb guard: the header's pixel count is checked
                # before convert() decodes anything
                check_image_pixels(img_raw)
                image = img_raw.convert("RGB")
            raw_detections = await self.batcher.submit(
                image, deadline=deadline, cls=cls, qset=qset)
            if boost > 0.0:
                bar = min(self.threshold + boost, 0.99)
                raw_detections = [d for d in raw_detections if d.get("score", 1.0) >= bar]
            if qset is None:
                detections = amenity_detections(raw_detections)
            else:  # the request's own label set: the taxonomy filter does not apply
                detections = [{"label": d["label"], "box": list(d["box"])}
                              for d in raw_detections]
            with obs.span(obs.POSTPROCESS, trace):
                jpeg = draw_detections(image, detections)
            return DetectionSuccessResult(
                url=url,
                detections=[DetectionResult(**d) for d in detections],
                labeled_image_base64=base64.b64encode(jpeg).decode("utf-8"),
            )
        except DeadlineExceededError as e:
            return DetectionErrorResult(url=url, error=f"Deadline exceeded: {e}")
        except AdmissionError:
            # detect() turns a fully shed request into HTTP 429/503
            raise
        except FetchError as e:
            return DetectionErrorResult(url=url, error=f"Fetch Error: {e}")
        except httpx.HTTPError as e:
            return DetectionErrorResult(url=url, error=f"HTTP Error: {e}")
        except Exception as e:
            tb_str = traceback.format_exc()
            return DetectionErrorResult(url=url, error=f"Processing Error: {e}\n{tb_str}")

    async def detect(
        self, payload: dict, deadline: Deadline | None = None, cls: str | None = None
    ) -> DetectionResponse:
        request = DetectionRequest.model_validate(payload)
        qset = None
        if request.queries:
            if self.text_resolver is None:
                raise QueriesUnsupportedError(
                    f"model '{self.model_name}' is closed-set: free-text "
                    f"`queries` need a text-conditioned family (OWL-ViT/OWLv2)"
                )
            # once per request; a novel vocabulary's encode runs off the loop
            qset = await asyncio.get_running_loop().run_in_executor(
                None, self.text_resolver.resolve, list(request.queries))
        if deadline is None:
            deadline = Deadline.from_env()
        urls = [str(u) for u in request.image_urls]
        gathered = await asyncio.gather(
            *(self._process_single_image(u, deadline, cls=cls, qset=qset) for u in urls),
            return_exceptions=True,
        )
        shed = [r for r in gathered if isinstance(r, AdmissionError)]
        if shed and len(shed) == len(gathered):
            raise shed[0]  # whole request shed -> HTTP 429/503 + Retry-After
        results: list[ImageResult] = []
        for url, r in zip(urls, gathered):
            if isinstance(r, AdmissionError):
                results.append(DetectionErrorResult(url=url, error=f"Overloaded: {r}"))
            elif isinstance(r, BaseException):
                raise r  # unexpected: _process_single_image contains the rest
            else:
                results.append(r)
        amenities = {
            d.label for r in results if isinstance(r, DetectionSuccessResult) for d in r.detections
        }
        brownout = self.batcher.brownout
        degraded = brownout.markers() if brownout is not None else []
        return DetectionResponse(
            amenities_description=amenities_description(amenities),
            images=results,
            degraded=degraded or None,
        )

    def check_admission(self, cls: str | None = None) -> AdmissionError | None:
        """HTTP-layer fast path: the AdmissionError to answer with before any
        fetch work, or None to proceed. Never consumes the breaker's
        half-open probe slot."""
        metrics = self.engine.metrics
        if self.batcher.draining:
            metrics.record_shed()
            return DrainingError("server draining")
        breaker = self.batcher.breaker
        if breaker.would_reject():
            metrics.record_shed()
            return CircuitOpenError("circuit breaker open", retry_after_s=breaker.retry_after_s())
        brownout = self.batcher.brownout
        if brownout is not None and cls == BULK:
            brownout.evaluate()
            if brownout.shed_bulk():
                metrics.record_shed()
                metrics.record_admit_shed(BULK)
                return BrownoutShedError(
                    f"brownout: bulk traffic shed (rung {brownout.rung})",
                    retry_after_s=jittered_retry_after(brownout.disarm_s),
                )
        return None

    def health(self) -> dict:
        """Readiness for /healthz: not ready while the breaker is open or
        probing, or a drain is in progress (liveness is /livez)."""
        breaker = self.batcher.breaker
        draining = self.batcher.draining
        ready = breaker.state == CircuitBreaker.CLOSED and not draining
        brownout = self.batcher.brownout
        rung = brownout.evaluate() if brownout is not None else 0
        return {
            "status": "brownout" if ready and rung > 0 else "ok" if ready else "unready",
            "ready": ready,
            "breaker": breaker.state,
            "draining": draining,
            "version": self.engine.metrics.version,
            "device": str(getattr(self.engine, "device", "unknown")),
            "ragged": self.batcher.scheduler.ragged,
            "brownout": brownout.snapshot() if brownout is not None else {"enabled": False},
            "admit": (
                self.batcher.limiter.snapshot()
                if self.batcher.limiter is not None else {"enabled": False}
            ),
            "open_vocab": (
                self.text_resolver.stats()
                if self.text_resolver is not None else {"enabled": False}
            ),
        }

    async def drain(self, timeout_s: float | None = None) -> dict:
        """Stop admitting, flush the queue, wait for in-flight batches."""
        return await self.batcher.drain(timeout_s)

    async def aclose(self) -> None:
        await self.batcher.stop()
        await self.client.aclose()
