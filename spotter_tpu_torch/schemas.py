"""Request/response schemas for the /detect API (copy of spotter_tpu.schemas).

Field names, nesting, and union shape are a wire contract with the reference
(apps/spotter/src/spotter/schemas.py:6-32): clients must be able to talk to
the port unchanged. `DetectionResponse.degraded` is the JAX package's
additive brownout marker, None and excluded from the wire (the serving
layers dump with `exclude_none=True`) on every non-degraded response.
`DetectionRequest.queries` is its open-vocabulary extension: the OWL-ViT
and OWLv2 families detect those labels instead of the deployment's
vocabulary, and a closed-set model answers such a request 400.
"""

from pydantic import BaseModel, HttpUrl


class DetectionRequest(BaseModel):
    image_urls: list[HttpUrl]
    # Open-vocabulary extension (additive like `degraded`): free-
    # text labels to detect INSTEAD of the deploy-time vocabulary. Only
    # text-conditioned families (OWL-ViT/OWLv2) accept it — closed-set
    # models answer 400; absent/None keeps the reference request shape and
    # behavior exactly.
    queries: list[str] | None = None


class DetectionResult(BaseModel):
    label: str
    # [xmin, ymin, xmax, ymax] in original-image pixel coordinates
    box: list[float]


class DetectionSuccessResult(BaseModel):
    url: str
    detections: list[DetectionResult]
    labeled_image_base64: str


class DetectionErrorResult(BaseModel):
    url: str
    error: str


ImageResult = DetectionSuccessResult | DetectionErrorResult


class DetectionResponse(BaseModel):
    amenities_description: str
    images: list[ImageResult]
    # brownout markers (see module docstring); None = not degraded, and the
    # serving layers drop it from the wire entirely
    degraded: list[str] | None = None
