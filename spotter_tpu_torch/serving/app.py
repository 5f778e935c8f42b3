"""Serving bootstrap: MODEL_NAME -> engine -> batcher -> detector (port of
spotter_tpu.serving.app).

MODEL_NAME is required and raises if unset, as in the reference's bootstrap
(serve.py:199-205). The replica serves one device (dp = 1, no mesh; several
GPUs come with the port's multi-GPU work) and runs on `cuda` unless the
caller asks for the CPU: with no GPU and no such request, it raises.

The JAX replica's tenancy and result-cache planes, its stub engine, and
the faults whose seams lie in planes the port does not have are not ported
(ROADMAP Queue 1 items 6, 10 and 12). Their knobs change what a replica
does, so bring-up refuses them rather than serve as if they were unset
(`refuse_unported_planes`). The output-integrity plane
(serving/integrity.py, `SPOTTER_TPU_INTEGRITY`, on by default) and the
other faults (testing/faults.py, `SPOTTER_TPU_FAULTS`) are served.
"""

import os

from spotter_tpu_torch.engine.batcher import MicroBatcher
from spotter_tpu_torch.engine.engine import InferenceEngine
from spotter_tpu_torch.engine.profiler import refuse_profiler_port
from spotter_tpu_torch.models.registry import build_detector
from spotter_tpu_torch.serving.detector import AmenitiesDetector
from spotter_tpu_torch.testing import faults

DETECTION_THRESHOLD = 0.5  # serve.py:107
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8)
BATCH_BUCKETS_ENV = "SPOTTER_TPU_BATCH_BUCKETS"
MAX_IN_FLIGHT_ENV = "SPOTTER_TPU_MAX_IN_FLIGHT"

# the JAX package's names (spotter_tpu/serving/tenancy.py,
# caching/result_cache.py)
TENANCY_KNOBS = (
    "SPOTTER_TPU_TENANT_KEYS", "SPOTTER_TPU_TENANT_CONFIG", "SPOTTER_TPU_TENANT_RPS_DEFAULT",
    "SPOTTER_TPU_TENANT_TOP_K", "SPOTTER_TPU_TENANT_EDGE_SECRET",
    "SPOTTER_TPU_TENANT_TRUST_HEADER",
)
CACHE_MAX_MB_ENV = "SPOTTER_TPU_CACHE_MAX_MB"
# spotter_tpu/testing/stub_engine.py
STUB_ENGINE_ENV = "SPOTTER_TPU_STUB_ENGINE"
UNPORTED_PLANES = "not ported (ROADMAP Queue 1 item 6); unset it to serve without it"


def refuse_unported_planes() -> None:
    """Raise when a knob of an unported serving plane asks for it: a tenancy
    knob set and not empty, SPOTTER_TPU_CACHE_MAX_MB above 0 (0 is the JAX
    default and keeps the cache off), SPOTTER_TPU_STUB_ENGINE set to anything
    but "" or "0" (the JAX package's two off values), a SPOTTER_TPU_FAULTS
    fault whose seam the port does not have (`faults.parse_spec`: an
    unknown fault or a bad value raises the JAX package's own text first);
    and SPOTTER_TPU_PROFILER_PORT set (`profiler.refuse_profiler_port`)."""
    for knob in TENANCY_KNOBS:
        raw = os.environ.get(knob, "")
        if raw.strip():
            raise ValueError(f"{knob}={raw!r}: the tenancy plane is {UNPORTED_PLANES}")
    raw = os.environ.get(CACHE_MAX_MB_ENV, "").strip()
    try:
        cache_mb = float(raw) if raw else 0.0
    except ValueError:
        raise ValueError(f"{CACHE_MAX_MB_ENV} must be a number, got {raw!r}") from None
    if cache_mb > 0:
        raise ValueError(f"{CACHE_MAX_MB_ENV}={raw!r}: the result cache is {UNPORTED_PLANES}")
    raw = os.environ.get(STUB_ENGINE_ENV, "0")
    if raw not in ("", "0"):
        raise ValueError(f"{STUB_ENGINE_ENV}={raw!r}: the stub engine is {UNPORTED_PLANES}")
    faults.parse_spec(os.environ.get(faults.FAULTS_ENV, "").strip())
    refuse_profiler_port()


def parse_batch_buckets(spec: str) -> tuple[int, ...]:
    """SPOTTER_TPU_BATCH_BUCKETS: comma-separated ascending bucket ladder."""
    try:
        buckets = tuple(int(v) for v in spec.split(","))
    except ValueError:
        buckets = ()
    if not buckets or any(b < 1 for b in buckets) or list(buckets) != sorted(set(buckets)):
        raise ValueError(
            f"{BATCH_BUCKETS_ENV} must be ascending positive ints, got {spec!r}"
        )
    return buckets


def build_detector_app(
    model_name: str | None = None,
    threshold: float = DETECTION_THRESHOLD,
    batch_buckets: tuple[int, ...] | None = None,
    max_delay_ms: float = 5.0,
    warmup: bool = False,
    device: str | None = None,
    tiny: bool | None = None,
    seed: int = 0,
) -> AmenitiesDetector:
    """Build the replica's detector. `device` None means `cuda` (raising
    where there is none); `tiny` None reads SPOTTER_TPU_TINY. A MODEL_NAME
    naming a local HF checkpoint directory loads its weights
    (`convert/loader.py`); a hub name builds the family with weights drawn
    from `seed`. `warmup` captures each bucket's CUDA graph before the
    detector is handed back."""
    refuse_unported_planes()
    model_name = model_name or os.environ.get("MODEL_NAME")
    if not model_name:
        raise ValueError("MODEL_NAME environment variable not set.")
    if batch_buckets is None:
        spec = os.environ.get(BATCH_BUCKETS_ENV)
        batch_buckets = parse_batch_buckets(spec) if spec is not None else DEFAULT_BATCH_BUCKETS
    built = build_detector(model_name, tiny=tiny, seed=seed)
    engine = InferenceEngine(built, threshold=threshold, batch_buckets=batch_buckets, device=device)
    if warmup:
        engine.warmup()
    max_in_flight = int(os.environ.get(MAX_IN_FLIGHT_ENV, "2"))
    batcher = MicroBatcher(engine, max_delay_ms=max_delay_ms, max_in_flight=max_in_flight)
    return AmenitiesDetector(engine, batcher)
