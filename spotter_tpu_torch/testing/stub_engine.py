"""Stub engine and stub fetch for model-free replica tests (the port's copy
of spotter_tpu.testing.stub_engine).

The layers under test here are everything above the forward pass: the
startup state machine, drain, the caches, tenancy, the wire format, the
integrity gate. `SPOTTER_TPU_STUB_ENGINE=1` (or `--stub-engine`) makes the
standalone server run this engine instead of a model: canned detections
that are a deterministic function of each image's pixels, an optional
fixed service time (`SPOTTER_TPU_STUB_SERVICE_MS`), nothing allocated on
any device. The detector's HTTP client is replaced by `StubHttpClient`,
so request URLs never leave the process.

Never production, and never a stand-in for a missing card: it runs only
when the knob asks for it, and the server logs loudly when it does.

Besides the JAX stub's surface (`batch_buckets`, `attest`,
`corrupt_weights`, `weights_digest`, `detect`) it has the two methods the
port's batcher and integrity gate read: `ran_buckets()` (the bucket each
image of the thread's last `detect` ran in) and `answer_class(bucket)`
(one class for every bucket: each answer is a function of its image
alone), so a stub replica passes its `verifying` gate.
"""

import hashlib
import os
import threading
import time
from io import BytesIO

STUB_ENGINE_ENV = "SPOTTER_TPU_STUB_ENGINE"
STUB_SERVICE_MS_ENV = "SPOTTER_TPU_STUB_SERVICE_MS"

# Labels must be AMENITIES_MAPPING keys so stub responses carry real
# detections end to end ("tv" -> "TV").
STUB_DETECTIONS = [{"label": "tv", "score": 0.9, "box": [2.0, 2.0, 20.0, 24.0]}]


def content_fingerprint(image) -> int:
    """Deterministic 16-bit fingerprint of an image's pixels (raw pixel
    bytes, never a re-encoded JPEG: two decodes of the same bytes, and the
    probe image built as an array, fingerprint the same everywhere)."""
    try:
        payload = image.tobytes()
    except Exception:
        payload = repr(image).encode()
    digest = hashlib.blake2b(payload, digest_size=2).digest()
    return digest[0] | (digest[1] << 8)


def stub_image_bytes(w: int = 32, h: int = 32, fill: int = 128) -> bytes:
    import numpy as np
    from PIL import Image

    img = Image.fromarray(np.full((h, w, 3), fill % 256, np.uint8))
    buf = BytesIO()
    img.save(buf, format="JPEG")
    return buf.getvalue()


class StubEngine:
    """Duck-typed InferenceEngine: metrics, batch_buckets, detect()."""

    def __init__(self, service_ms: float | None = None,
                 detections: list[dict] | None = None) -> None:
        from spotter_tpu_torch.engine.metrics import Metrics

        if service_ms is None:
            raw = os.environ.get(STUB_SERVICE_MS_ENV, "").strip()
            service_ms = float(raw) if raw else 0.0
        self.service_s = max(service_ms, 0.0) / 1000.0
        # a per-instance copy: corrupt_weights() mutates it in place
        self.detections = [
            dict(d) for d in (detections if detections is not None else STUB_DETECTIONS)
        ]
        self.metrics = Metrics()
        self.metrics.set_identity(model="stub")
        self.batch_buckets = (1, 2, 4, 8)
        self._ran = threading.local()
        # the trusted attestation reference, taken at load time before any
        # fault can corrupt the canned "weights"
        self._attest_reference = self._checksum()

    def _checksum(self) -> int:
        digest = hashlib.sha256(repr(self.detections).encode()).digest()
        return int.from_bytes(digest[:4], "big")

    def attest(self) -> dict:
        """InferenceEngine.attest()'s contract: the live checksum of what the
        stub would answer now against the load-time reference."""
        observed = self._checksum()
        ok = observed == self._attest_reference
        return {
            "ok": ok,
            "checked": 1,
            "mismatched": [] if ok else ["stub:0"],
            "observed": {"stub:0": observed},
            "expected": {"stub:0": self._attest_reference},
        }

    def corrupt_weights(self, n: int) -> None:
        """The `corrupt_weights=<n>` fault seam: perturb the first `n` canned
        detections as a flipped weight bit perturbs real outputs."""
        for det in self.detections[: max(int(n), 0)]:
            det["score"] = round(min(float(det.get("score", 0.0)) + 0.11, 1.0), 4)

    def bucket_for(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    def answer_class(self, bucket: int) -> str:
        """Every bucket answers an image alike (the answer is a function of
        the image alone), so every pin is held to bucket 1's."""
        return "stub"

    def ran_buckets(self) -> list[int]:
        """The bucket each image of this thread's last `detect` ran in."""
        return list(getattr(self._ran, "buckets", ()))

    def _detections_for(self, image) -> list[dict]:
        h = content_fingerprint(image)
        d_score = (h % 8) / 100.0
        d_box = float((h >> 3) % 8)
        out = []
        for det in self.detections:
            d = dict(det)
            try:
                score = float(d.get("score", 0.0))
            except (TypeError, ValueError):
                score = 0.0
            d["score"] = round(min(max(score - d_score, 0.0), 1.0), 4)
            box = d.get("box")
            if isinstance(box, (list, tuple)) and len(box) == 4:
                d["box"] = [round(float(v) + d_box, 2) for v in box]
            out.append(d)
        return out

    def weights_digest(self) -> str:
        """Content fingerprint of the canned output: two stubs with
        different detections report different digests."""
        return hashlib.sha256(repr(self.detections).encode()).hexdigest()[:12]

    def warmup(self) -> None:  # InferenceEngine's surface
        pass

    def detect(self, images):
        """The canned answers, with the real engine's stage windows (its
        "device" window is the service sleep, where the `slow_replica`
        fault lands) and per-image outputs that depend on each image's
        pixels, so diff-based checks do not pass vacuously."""
        from spotter_tpu_torch import obs
        from spotter_tpu_torch.testing import faults

        top, buckets = self.batch_buckets[-1], []
        for i in range(0, len(images), top):
            n = min(top, len(images) - i)
            buckets += [self.bucket_for(n)] * n
        self._ran.buckets = buckets
        t0 = time.monotonic()
        faults.sleep_stage(obs.DECODE)
        t_decode = time.monotonic()
        faults.sleep_stage(obs.H2D)
        t_h2d = time.monotonic()
        faults.sleep_stage(obs.DEVICE)
        delay_s = faults.replica_delay_s(self.metrics.replica_id)
        if delay_s > 0:
            time.sleep(delay_s)
        if self.service_s > 0:
            time.sleep(self.service_s)
        t_dev = time.monotonic()
        faults.sleep_stage(obs.POSTPROCESS)
        out = [faults.corrupt_detections(self._detections_for(img), self.metrics.replica_id)
               for img in images]
        t_post = time.monotonic()
        stage_windows = [
            (obs.DECODE, t0, t_decode),
            (obs.H2D, t_decode, t_h2d),
            (obs.DEVICE, t_h2d, t_dev),
            (obs.POSTPROCESS, t_dev, t_post),
        ]
        obs.record_engine_spans(stage_windows)
        self.metrics.record_batch(
            len(images), t_post - t0,
            stages={name: t_end - t_start for name, t_start, t_end in stage_windows},
            trace_id=obs.batch_trace_id(),
        )
        # no FLOPs (no program): MFU stays 0, the duty cycle is real
        self.metrics.perf.record_dispatch(
            device_s=t_dev - t_h2d, batch=len(images), trace_id=obs.batch_trace_id(),
            shape=f"stub:{len(images)}",
        )
        return out


class _StubResponse:
    def __init__(self, content: bytes) -> None:
        self.content = content

    def raise_for_status(self) -> None:
        pass


class StubHttpClient:
    """Stands in for the detector's httpx.AsyncClient in stub mode: every GET
    returns a small canned JPEG without touching the network. Distinct URLs
    get distinct bytes (the fill from the URL's hash), so content keys
    behave like real traffic; a small memo keeps repeat fetches free."""

    _MEMO_MAX = 64

    def __init__(self) -> None:
        self._memo: dict[int, bytes] = {}

    async def get(self, url: str) -> _StubResponse:
        fill = hashlib.blake2b(url.encode(), digest_size=1).digest()[0]
        body = self._memo.get(fill)
        if body is None:
            if len(self._memo) >= self._MEMO_MAX:
                self._memo.clear()
            body = stub_image_bytes(fill=fill)
            self._memo[fill] = body
        return _StubResponse(body)

    async def aclose(self) -> None:
        pass


def stub_mode_enabled() -> bool:
    """The JAX package's rule: on for any value but "" and "0"."""
    return os.environ.get(STUB_ENGINE_ENV, "0") not in ("", "0")


def build_stub_detector():
    """AmenitiesDetector over a StubEngine and a StubHttpClient (the
    standalone server's bring-up in stub mode)."""
    from spotter_tpu_torch.engine.batcher import MicroBatcher
    from spotter_tpu_torch.serving.detector import AmenitiesDetector

    engine = StubEngine()
    batcher = MicroBatcher(engine, max_delay_ms=2.0)
    return AmenitiesDetector(engine, batcher, StubHttpClient())
