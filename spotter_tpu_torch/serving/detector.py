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

The caching tier (opt-in, `SPOTTER_TPU_CACHE_MAX_MB`; caching/): detection
is deterministic per (model, image bytes, threshold), so three exact
short-circuits come before any engine work: (1) URL single-flight, N
concurrent requests for one URL share one fetch; (2) the negative cache, a
recent deterministic failure (a non-retryable 4xx fetch, a poison image)
re-raises at once; (3) the content-addressed result cache, byte-identical
images skip the engine (a hit still decodes and draws, unless the entry
carries the finished JPEG and the brownout threshold rung is off). A miss
submits with the content key, which the batcher coalesces on and fills
the cache from. `detect(..., info=...)` collects each URL's outcome (the
`X-Cache` header) and its deterministic-failure verdicts (the
`X-Spotter-Negative` header). With the knob unset none of this is built.

With the tenancy plane attached (`attach_tenancy`), each request's tenant
rides into every batcher submit and scopes the brownout's bulk shed.
"""

import asyncio
import base64
import traceback
from io import BytesIO

import httpx
from PIL import Image, ImageDraw

from spotter_tpu_torch import obs
from spotter_tpu_torch.caching.keys import content_key, url_key
from spotter_tpu_torch.caching.result_cache import ResultCache
from spotter_tpu_torch.caching.singleflight import SingleFlight
from spotter_tpu_torch.caching.text_cache import TextQueryResolver
from spotter_tpu_torch.engine.batcher import MicroBatcher
from spotter_tpu_torch.engine.errors import PoisonImageError
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


# default for AmenitiesDetector(cache=...): build from the env knobs (None
# when SPOTTER_TPU_CACHE_MAX_MB is unset or 0). Pass None to force the tier
# off, or a ResultCache to use it whatever the env says.
_CACHE_FROM_ENV = object()


def _mark_outcome(info: dict | None, url: str, outcome: str) -> None:
    """A URL's caching-tier outcome for the `X-Cache` header; the first
    write wins ("the cache served this" outranks later bookkeeping)."""
    if info is not None:
        info.setdefault("cache", {}).setdefault(url, outcome)


def _note_verdict(info: dict | None, url: str, kind: str, error: str, ttl_s: float) -> None:
    """A deterministic-failure verdict for this URL, for the
    `X-Spotter-Negative` header (only the result cache's deterministic
    failures land here)."""
    if info is not None:
        info.setdefault("negative", {})[url] = {"kind": kind, "error": error, "ttl_s": ttl_s}


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
        cache: ResultCache | None | object = _CACHE_FROM_ENV,
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
        # the caching tier, per detector (two detectors in one process share
        # nothing); None means every path below is the cache-less one
        if cache is _CACHE_FROM_ENV:
            cache = ResultCache.from_env(metrics=engine.metrics)
        self.cache: ResultCache | None = cache
        self._fetch_flights = SingleFlight(on_coalesced=engine.metrics.record_coalesced_fetch)
        if self.cache is not None and self.batcher.result_cache is None:
            self.batcher.result_cache = self.cache
        # the tenant isolation plane; None unless the serving layer attaches one
        self.tenancy = None

    def attach_tenancy(self, plane) -> None:
        """Wire the tenant isolation plane through the detector into the
        batcher's arbiters. None is a no-op."""
        if plane is None:
            return
        self.tenancy = plane
        self.batcher.attach_tenancy(plane)

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

    async def _fetch_flight(self, url: str) -> bytes:
        """The shared fetch flight (cache tier on): one per URL at a time,
        deadline-free (waiters apply their own budgets around it). A
        deterministic failure lands in the negative cache on the way out;
        a retryable one (5xx, 408/429, timeouts, connect errors) never."""
        try:
            return await self._fetch_with_retries(url)
        except FetchError as exc:
            if not exc.retryable:
                self.cache.put_negative(url_key(url), exc)
            raise
        except httpx.HTTPStatusError as exc:
            code = exc.response.status_code
            if 400 <= code < 500 and code not in RETRYABLE_4XX:
                self.cache.put_negative(url_key(url), exc)
            raise

    async def _fetch_for_request(self, url: str, deadline: Deadline | None,
                                 info: dict | None = None) -> bytes:
        if self.cache is None:  # tier off: the plain fetch
            fetch = self._fetch_with_retries(url, deadline)
            if deadline is not None:
                return await deadline.wait_for(fetch, "image fetch")
            return await fetch
        cached_failure = self.cache.get_negative(url_key(url))
        if cached_failure is not None:
            _mark_outcome(info, url, "negative")
            raise cached_failure
        return await self._fetch_flights.run(
            url, lambda: self._fetch_flight(url), deadline=deadline, what="image fetch")

    async def _process_single_image(
        self, url: str, deadline: Deadline | None = None, cls: str | None = None,
        qset=None, degraded: set[str] | None = None, info: dict | None = None,
        tenant: str | None = None,
    ) -> ImageResult:
        # the ambient request trace: None (recorder off, or a bare library
        # call) makes every span below a no-op
        trace = obs.current_trace()
        brownout = self.batcher.brownout
        # brownout threshold rung: read once, up front, for the whole image
        # (the annotated fast hit is valid only at the base threshold)
        boost = brownout.threshold_boost_value() if brownout is not None else 0.0
        try:
            with obs.span(obs.FETCH, trace):
                image_bytes = await self._fetch_for_request(url, deadline, info)
            with obs.span(obs.DECODE, trace):
                cache_key, raw_detections, annotated = None, None, None
                if self.cache is not None:
                    cache_key = content_key(self.model_name, image_bytes, self.threshold)
                    if qset is not None:
                        # the detections depend on the vocabulary too
                        cache_key = f"{cache_key}|q{qset.digest}"
                    # a repeat poison re-raises its verdict instead of
                    # poisoning a batch again
                    cached_failure = self.cache.get_negative(cache_key)
                    if cached_failure is not None:
                        _mark_outcome(info, url, "negative")
                        raise cached_failure
                    # the brownout's stale rung: an expired entry beats a
                    # forward, and the response is marked `degraded: stale`
                    raw_detections, was_stale, annotated = self.cache.get_entry_full(
                        cache_key, stale_ok=brownout is not None and brownout.stale_ok())
                    if was_stale and degraded is not None:
                        degraded.add("stale")
                    if raw_detections is not None:
                        _mark_outcome(info, url, "hit")
                use_annotated = (
                    raw_detections is not None and annotated is not None and boost == 0.0
                )
                if not use_annotated:
                    with Image.open(BytesIO(image_bytes)) as img_raw:
                        # decode-bomb guard: the header's pixel count is
                        # checked before convert() decodes anything
                        check_image_pixels(img_raw)
                        image = img_raw.convert("RGB")
            if use_annotated:
                # the entry holds the finished JPEG and filtered boxes: no
                # decode, draw or re-encode
                with obs.span(obs.POSTPROCESS, trace):
                    return DetectionSuccessResult(
                        url=url,
                        detections=[DetectionResult(label=d["label"], box=list(d["box"]))
                                    for d in annotated["detections"]],
                        labeled_image_base64=base64.b64encode(annotated["jpeg"]).decode("utf-8"),
                    )
            if raw_detections is None:
                # a miss: the content key rides into the batcher for
                # coalescing and the cache fill
                if cache_key is not None:
                    _mark_outcome(info, url,
                                  "coalesced" if self.batcher.in_flight(cache_key) else "miss")
                raw_detections = await self.batcher.submit(
                    image, deadline=deadline, key=cache_key, cls=cls, qset=qset, tenant=tenant)
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
            # the annotated sidecar, at the base threshold only (a boosted
            # view must not narrow the base entry's boxes)
            if cache_key is not None and boost == 0.0:
                self.cache.attach_annotated(cache_key, jpeg, detections)
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
            if self.cache is not None and not e.retryable:
                _note_verdict(info, url, "fetch", f"Fetch Error: {e}", self.cache.negative_ttl_s)
            return DetectionErrorResult(url=url, error=f"Fetch Error: {e}")
        except httpx.HTTPError as e:
            if (self.cache is not None and isinstance(e, httpx.HTTPStatusError)
                    and 400 <= e.response.status_code < 500
                    and e.response.status_code not in RETRYABLE_4XX):
                _note_verdict(info, url, "fetch", f"HTTP Error: {e}", self.cache.negative_ttl_s)
            return DetectionErrorResult(url=url, error=f"HTTP Error: {e}")
        except Exception as e:
            tb_str = traceback.format_exc()
            if self.cache is not None and isinstance(e, PoisonImageError):
                # poison is keyed by content in the cache, but an edge knows
                # URLs: the verdict names the URL that carried the bytes
                _note_verdict(info, url, "poison", f"Processing Error: {e}",
                              self.cache.negative_ttl_s)
            return DetectionErrorResult(url=url, error=f"Processing Error: {e}\n{tb_str}")

    async def detect(
        self, payload: dict, deadline: Deadline | None = None, cls: str | None = None,
        info: dict | None = None, tenant: str | None = None,
    ) -> DetectionResponse:
        """`info` (optional dict) collects per-URL observations for the HTTP
        layer: `info["cache"]` maps url -> hit|miss|negative|coalesced and
        `info["negative"]` holds the deterministic-failure verdicts. `tenant`
        rides into every batcher submit. None for both keeps the plain
        path."""
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
        degraded: set[str] = set()
        gathered = await asyncio.gather(
            *(self._process_single_image(u, deadline, cls=cls, qset=qset, degraded=degraded,
                                         info=info, tenant=tenant) for u in urls),
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
        # "stale" when an image was served from an expired entry, plus the
        # active rungs' markers
        brownout = self.batcher.brownout
        if brownout is not None:
            degraded.update(brownout.markers())
        return DetectionResponse(
            amenities_description=amenities_description(amenities),
            images=results,
            degraded=sorted(degraded) if degraded else None,
        )

    def check_admission(self, cls: str | None = None,
                        tenant: str | None = None) -> AdmissionError | None:
        """HTTP-layer fast path: the AdmissionError to answer with before any
        fetch work, or None to proceed. Never consumes the breaker's
        half-open probe slot. `tenant` scopes the brownout's bulk shed to
        over-share tenants."""
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
            if brownout.shed_bulk(tenant):
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
            # the caching tier's size state (its counters are in /metrics)
            "cache": self.cache.stats() if self.cache is not None else {"enabled": False},
            "tenancy": (
                self.tenancy.snapshot() if self.tenancy is not None else {"enabled": False}
            ),
        }

    async def drain(self, timeout_s: float | None = None) -> dict:
        """Stop admitting, flush the queue, wait for in-flight batches."""
        return await self.batcher.drain(timeout_s)

    async def aclose(self) -> None:
        await self.batcher.stop()
        await self.client.aclose()
