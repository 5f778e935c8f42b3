"""Serving bootstrap: MODEL_NAME -> engine -> batcher -> detector, and the
Ray Serve adapter (port of spotter_tpu.serving.app).

MODEL_NAME is required and raises if unset, as in the reference's bootstrap
(serve.py:199-205). The replica serves one device (dp = 1, no mesh; several
GPUs come with the port's multi-GPU work) and runs on `cuda` unless the
caller asks for the CPU: with no GPU and no such request, it raises.

The replica's planes are served: the output-integrity plane
(serving/integrity.py, `SPOTTER_TPU_INTEGRITY`, on by default), tenancy
(serving/tenancy.py, wired by the standalone server), the result cache
(`SPOTTER_TPU_CACHE_MAX_MB`, set by the `--cache-mb` flag; off by default), the stub engine
(testing/stub_engine.py) and the fault seams (testing/faults.py). A
`SPOTTER_TPU_FAULTS` fault whose seam lies in a plane the port does not
have (multi-GPU serving, the fleet tier: ROADMAP Queue 1 items 10 and 12)
and `SPOTTER_TPU_PROFILER_PORT` change what a replica does, so bring-up
refuses them rather than serve as if they were unset
(`refuse_unported_planes`).

Ray Serve is optional: `deployment` is the manifest's import_path target
(rayservice-template.yaml), None when `ray` is not installed; with `ray`
installed a bring-up error (MODEL_NAME unset) raises at import, as the
reference's module-level bootstrap does.
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


def refuse_unported_planes() -> None:
    """Raise when a knob asks for a plane the port does not have: a
    SPOTTER_TPU_FAULTS fault whose seam is not ported (`faults.parse_spec`:
    an unknown fault or a bad value raises the JAX package's own text
    first), or SPOTTER_TPU_PROFILER_PORT set (`profiler.refuse_profiler_port`)."""
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
    detector is handed back. The detector builds the result cache from
    SPOTTER_TPU_CACHE_MAX_MB; unset, none of its machinery is built."""
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


def ray_deployment():
    """The Ray Serve deployment graph node (the manifest's import_path
    target): each Ray replica builds the detector, warmed, and routes the
    request's JSON body to `AmenitiesDetector.detect`."""
    from ray import serve
    from starlette.requests import Request

    @serve.deployment
    class RayAmenitiesDetector:
        def __init__(self, model_name: str) -> None:
            self._inner = build_detector_app(model_name, warmup=True)

        async def __call__(self, raw_payload: "Request"):
            return await self._inner.detect(await raw_payload.json())

    model_name = os.environ.get("MODEL_NAME")
    if not model_name:
        raise ValueError("MODEL_NAME environment variable not set.")
    return RayAmenitiesDetector.bind(model_name)


try:  # the module-level `deployment` the manifest's import_path names
    import ray  # noqa: F401
except ImportError:  # Ray not installed: the standalone server serves
    deployment = None
else:
    # with Ray present a bring-up error must raise at import, as the
    # reference's does (serve.py:199-201), not become import_path=None
    deployment = ray_deployment()
