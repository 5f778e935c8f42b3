"""Inference engine: batch-bucket ladder, padded batching, device forward
(port of spotter_tpu.engine.engine, lean form).

What it keeps of the JAX engine: batch sizes come from a fixed ladder
(1, 2, 4, 8 by default) and each chunk pads up to its bucket, `warmup`
runs every bucket once ahead of traffic, the device returns fixed-k
(scores, labels, boxes) and the host thresholds them. It takes decoded
uint8 HWC images (numpy); the host resizes them to the spec and stacks
them, the device rescales, runs the model and the family's postprocess
(sigmoid top-k for RT-DETR, per-query softmax for YOLOS).

It takes what the batcher hands over (PIL images) or decoded uint8 HWC
arrays, and classifies device failures as the JAX engine does
(`engine/errors.py`): an out-of-memory chunk is split in half and retried
once, serially (the next smaller bucket); a fatal device error, a poisoned
CUDA context included, raises `FatalEngineError`; anything else propagates
for the batcher's poison bisect. One lock serialises the device half of
concurrent `detect` calls (the batcher's worker threads), so one batch's
host resize overlaps another's forward.

Not ported yet: weights attestation, sharding, open-vocabulary query sets,
the perf ledger and CUDA graphs.
"""

import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from spotter_tpu_torch.engine.errors import (
    FatalEngineError,
    TransientEngineError,
    as_typed,
    classify_engine_exception,
)
from spotter_tpu_torch.engine.metrics import Metrics
from spotter_tpu_torch.ops.postprocess import (
    sigmoid_topk_postprocess,
    softmax_postprocess,
    to_detections,
)
from spotter_tpu_torch.ops.preprocess import (
    PreprocessSpec,
    batch_images_uint8,
    device_rescale_normalize,
)
from spotter_tpu_torch.utils.precision import use_exact_float32

POSTPROCESS_KINDS = ("sigmoid_topk", "softmax")  # RT-DETR; DETR/YOLOS


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`device` as given, or `cuda` when None.

    With None and no GPU present this raises: the engine never carries on
    quietly on the CPU. The CPU runs only when the caller names it.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


@dataclass
class BuiltDetector:
    """Everything the engine needs for one loaded model (registry output)."""

    model_name: str
    module: nn.Module  # weights loaded; (B, H, W, 3) float pixels -> dict
    preprocess_spec: PreprocessSpec
    postprocess: str  # one of POSTPROCESS_KINDS
    id2label: dict[int, str]
    num_top_queries: int = 300


class InferenceEngine:
    """Owns the model on its device; turns uint8 images into detections."""

    def __init__(
        self,
        built: BuiltDetector,
        threshold: float = 0.5,
        batch_buckets: Sequence[int] = (1, 2, 4, 8),
        device: str | torch.device | None = None,
    ) -> None:
        """`device`: where the model runs; None means `cuda`, and raises
        where there is no GPU (pass "cpu" to run on the CPU)."""
        if built.postprocess not in POSTPROCESS_KINDS:
            raise ValueError(f"postprocess {built.postprocess!r} is not ported")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_exact_float32()
        self.built = built
        self.threshold = threshold
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.model = built.module.to(self.device).eval()
        self.metrics = Metrics()
        self._device_lock = threading.Lock()

    def bucket_for(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    def _forward(
        self, pixels_u8: torch.Tensor, target_sizes: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Device half: (B, H, W, 3) uint8 + (B, 2) sizes -> fixed-k outputs."""
        pixels = device_rescale_normalize(pixels_u8, self.built.preprocess_spec)
        out = self.model(pixels)
        logits = out["logits"]
        if self.built.postprocess == "softmax":
            return softmax_postprocess(logits, out["pred_boxes"], target_sizes)
        kk = min(self.built.num_top_queries, logits.shape[1] * logits.shape[2])
        return sigmoid_topk_postprocess(logits, out["pred_boxes"], target_sizes, k=kk)

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run every bucket of the ladder once ahead of traffic (cuDNN picks
        its algorithms and the kernel library builds on the first call)."""
        h, w = self.built.preprocess_spec.input_hw
        for b in self.batch_buckets:
            pixels = torch.zeros((b, h, w, 3), dtype=torch.uint8, device=self.device)
            sizes = torch.ones((b, 2), dtype=torch.float32, device=self.device)
            outputs = self._forward(pixels, sizes)
            [t.cpu() for t in outputs]

    def detect(
        self,
        images: list,
        canvas_hw: Optional[tuple[int, int]] = None,
        qset=None,
    ) -> list[list[dict]]:
        """Images -> per-image lists of {"label", "score", "box"}.

        `images` are PIL images (what the batcher hands over) or uint8
        (H, W, 3) arrays. Splits into chunks of the largest bucket, pads each
        chunk's batch to its bucket and drops the pad rows' results. Boxes
        are in each image's own pixel coordinates. `canvas_hw` is the
        ragged scheduler's canvas; the ported families' fixed specs ignore it.
        `qset` (an open-vocabulary query set) raises: the port serves only
        closed-set models, as the JAX engine does for them.
        """
        if qset is not None:
            raise ValueError(
                f"{self.built.model_name} is a closed-set family: it has no "
                f"text encoder, so per-request `queries` are unsupported"
            )
        del canvas_hw  # fixed-size spec: the canvas is the static bucket
        arrays = [as_uint8_rgb(img) for img in images]
        max_b = self.batch_buckets[-1]
        results: list[list[dict]] = []
        for start in range(0, len(arrays), max_b):
            chunk = arrays[start : start + max_b]
            try:
                results.extend(self._detect_chunk(chunk))
            except Exception as exc:
                results.extend(self._recover_chunk(chunk, exc))
        return results

    def _recover_chunk(self, chunk: list[np.ndarray], exc: Exception) -> list[list[dict]]:
        """Classify a failed chunk and recover when the taxonomy allows it:
        an out-of-memory chunk drops to the next smaller bucket (split in
        half, retried once, serially); a second failure propagates typed."""
        kind = classify_engine_exception(exc)
        if kind is FatalEngineError:
            raise as_typed(exc) from exc
        if kind is not TransientEngineError:
            raise exc
        self.metrics.record_batch_retry()
        try:
            if len(chunk) <= 1:
                return self._detect_chunk(chunk)
            mid = (len(chunk) + 1) // 2
            return self._detect_chunk(chunk[:mid]) + self._detect_chunk(chunk[mid:])
        except Exception as retry_exc:
            raise as_typed(retry_exc) from retry_exc

    @torch.inference_mode()
    def _detect_chunk(self, chunk: list[np.ndarray]) -> list[list[dict]]:
        """Host resize, then (under the device lock) H2D, forward, top-k and
        D2H, then thresholding on the host, for one chunk <= the top bucket."""
        t0 = time.monotonic()
        n = len(chunk)
        pixels, _, sizes = batch_images_uint8(chunk, self.built.preprocess_spec)
        bucket = self.bucket_for(n)
        if bucket > n:  # pad the batch to the static bucket size
            pad = bucket - n
            pixels = np.concatenate([pixels, np.zeros((pad, *pixels.shape[1:]), np.uint8)])
            sizes = np.concatenate([sizes, np.ones((pad, 2), np.float32)])
        t_host = time.monotonic()
        with self._device_lock:
            outputs = self._forward(
                torch.from_numpy(pixels).to(self.device),
                torch.from_numpy(sizes).to(self.device),
            )
            scores, labels, boxes = (t.cpu().numpy() for t in outputs)
        t_dev = time.monotonic()
        out = [
            to_detections(scores[j], labels[j], boxes[j], self.built.id2label, self.threshold)
            for j in range(n)
        ]
        t_post = time.monotonic()
        self.metrics.record_batch(
            n, t_post - t0,
            stages={"decode": t_host - t0, "device": t_dev - t_host, "postprocess": t_post - t_dev},
        )
        return out


def as_uint8_rgb(image) -> np.ndarray:
    """A PIL image or a uint8 (H, W, 3) array -> uint8 (H, W, 3) array."""
    if isinstance(image, np.ndarray):
        return image
    if image.mode != "RGB":
        image = image.convert("RGB")
    return np.array(image)  # a writable copy: torch.from_numpy takes it as is
