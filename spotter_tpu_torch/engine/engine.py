"""Inference engine: batch-bucket ladder, padded batching, device forward
(port of spotter_tpu.engine.engine, lean form).

What it keeps of the JAX engine: batch sizes come from a fixed ladder
(1, 2, 4, 8 by default) and each chunk pads up to its bucket, `warmup`
runs every bucket once ahead of traffic, the device returns fixed-k
(scores, labels, boxes) and the host thresholds them. It takes decoded
uint8 HWC images (numpy); the host resizes them to the spec and stacks
them, the device rescales, runs the model and the top-k postprocess.

Not ported yet: the fault taxonomy and bucket-downgrade retry, weights
attestation, sharding, open-vocabulary query sets, the perf ledger and
CUDA graphs.
"""

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
from torch import nn

from spotter_tpu_torch.ops.postprocess import sigmoid_topk_postprocess, to_detections
from spotter_tpu_torch.ops.preprocess import (
    PreprocessSpec,
    batch_images_uint8,
    device_rescale_normalize,
)
from spotter_tpu_torch.utils.precision import compute_dtype, backbone_dtype, use_exact_float32


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
    postprocess: str  # only "sigmoid_topk" (the RT-DETR family) is ported
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
        if built.postprocess != "sigmoid_topk":
            raise ValueError(f"postprocess {built.postprocess!r} is not ported")
        if compute_dtype() != torch.float32 or backbone_dtype() != torch.float32:
            raise ValueError("only the float32 precision policy is ported")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_exact_float32()
        self.built = built
        self.threshold = threshold
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.model = built.module.to(self.device).eval()

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

    @torch.inference_mode()
    def detect(self, images: list[np.ndarray]) -> list[list[dict]]:
        """uint8 (H, W, 3) images -> per-image lists of {"label", "score", "box"}.

        Splits into chunks of the largest bucket, pads each chunk's batch to
        its bucket and drops the pad rows' results. Boxes are in each
        image's own pixel coordinates.
        """
        results: list[list[dict]] = []
        max_b = self.batch_buckets[-1]
        spec = self.built.preprocess_spec
        for start in range(0, len(images), max_b):
            chunk = images[start : start + max_b]
            n = len(chunk)
            pixels, _, sizes = batch_images_uint8(chunk, spec)
            bucket = self.bucket_for(n)
            if bucket > n:  # pad the batch to the static bucket size
                pad = bucket - n
                pixels = np.concatenate([pixels, np.zeros((pad, *pixels.shape[1:]), np.uint8)])
                sizes = np.concatenate([sizes, np.ones((pad, 2), np.float32)])
            outputs = self._forward(
                torch.from_numpy(pixels).to(self.device),
                torch.from_numpy(sizes).to(self.device),
            )
            scores, labels, boxes = (t.cpu().numpy() for t in outputs)
            results.extend(
                to_detections(scores[j], labels[j], boxes[j], self.built.id2label, self.threshold)
                for j in range(n)
            )
        return results
