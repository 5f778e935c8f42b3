"""Inference engine: batch-bucket ladder, padded batching, device forward
(port of spotter_tpu.engine.engine, lean form).

What it keeps of the JAX engine: batch sizes come from a fixed ladder
(1, 2, 4, 8 by default) and each chunk pads up to its bucket, `warmup`
runs every bucket once ahead of traffic, the device returns fixed-k
(scores, labels, boxes) and the host thresholds them. It takes decoded
uint8 HWC images (numpy); the host resizes them to the spec and stacks
them, the device rescales, runs the model and the family's postprocess
(sigmoid top-k for RT-DETR and Deformable-DETR, per-query softmax for
YOLOS, per-patch sigmoid max for OWL-ViT). A model that takes a pixel mask
(`needs_mask`: Deformable-DETR's shortest-edge spec stages each photo at the
top left of a 1333x1333 bucket) gets it from each image's valid extent,
built on the device with the rescale; padded batch rows are zero pixels
with a mask of ones, as in the JAX engine; boxes are scaled to each
photo's own size.

Open-vocabulary families (OWL-ViT, OWLv2) bring a build-time query bank,
which the engine keeps on its device and passes to every forward, and a
text encoder: `detect(..., qset=)` runs the model against a request's own
resolved query set instead (caching/text_cache.py), keeping each set's
device copy per key, and labels its detections from that set. OWLv2's
pad-to-square spec preprocesses in float on the host, so its pixels cross
to the device as float32; the fixed specs ship uint8.

It takes what the batcher hands over (PIL images) or decoded uint8 HWC
arrays, and classifies device failures as the JAX engine does
(`engine/errors.py`): an out-of-memory chunk is split in half and retried
once, serially (the next smaller bucket); a fatal device error, a poisoned
CUDA context included, raises `FatalEngineError`; anything else propagates
for the batcher's poison bisect. One lock serialises the device half of
concurrent `detect` calls (the batcher's worker threads), so one batch's
host resize overlaps another's forward.

Not ported yet: weights attestation, sharding, the perf ledger and CUDA
graphs.
"""

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

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
    sigmoid_max_postprocess,
    sigmoid_topk_postprocess,
    softmax_postprocess,
    to_detections,
)
from spotter_tpu_torch.ops.preprocess import (
    PreprocessSpec,
    batch_images_float,
    batch_images_uint8,
    device_preprocess_supported,
    device_rescale_normalize,
    device_rescale_normalize_masked,
)
from spotter_tpu_torch.utils.precision import use_exact_float32

POSTPROCESS_KINDS = ("sigmoid_topk", "softmax", "sigmoid_max")  # RT-DETR; DETR/YOLOS; OWL-ViT
# ragged canvas packing (the JAX scheduler's smaller canvases for
# shortest-edge specs) is not ported
RAGGED_SHORTEST_EDGE_ERROR = (
    "ragged canvas packing for shortest_edge specs (SPOTTER_TPU_RAGGED=1 with the "
    "DETR family) is not ported: ROADMAP Queue 1 item 6"
)
# query sets whose device copies the engine keeps, least recently used
# dropped first (the text cache's default bound)
QSET_DEVICE_ENTRIES = 256


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
    # open-vocabulary families: the deployment vocabulary's normalized
    # (Q, proj) fp32 query bank, encoded once at build time, and the text
    # encoder for a request's own queries (list[str] -> (Q, proj) float32
    # numpy). Both None for closed-set families, which then refuse `qset`.
    query_embeds: Optional[torch.Tensor] = None
    text_encoder: Optional[Callable] = None
    # the module takes (pixels, pixel_mask): the shortest-edge families
    needs_mask: bool = False


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
        # fixed specs ship uint8 and normalize on the device; pad_square is float on the host
        self.device_preprocess = device_preprocess_supported(built.preprocess_spec)
        self._query_embeds = (
            None if built.query_embeds is None else built.query_embeds.to(self.device)
        )
        self._qset_tensors: OrderedDict[str, tuple[torch.Tensor, torch.Tensor]] = OrderedDict()
        self.metrics = Metrics()
        self._device_lock = threading.Lock()

    def bucket_for(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    def _forward(
        self,
        pixels: torch.Tensor,
        target_sizes: torch.Tensor,
        queries: Optional[tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
        valid: Optional[torch.Tensor] = None,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Device half: (B, H, W, 3) pixels (uint8, or the float path's
        normalized float32) + (B, 2) sizes -> fixed-k outputs. An
        open-vocabulary model runs against `queries` (embeddings, mask),
        by default the build-time bank with no mask. A model that needs a
        pixel mask gets it from `valid` (B, 2), each image's (h, w) in the
        bucket (None: the whole bucket)."""
        spec = self.built.preprocess_spec
        if self.built.needs_mask:
            if valid is None:
                valid = torch.tensor([spec.input_hw], dtype=torch.int32,
                                     device=pixels.device).expand(pixels.shape[0], 2)
            pixels, mask = device_rescale_normalize_masked(pixels, valid, spec)
            out = self.model(pixels, mask)
        else:
            if pixels.dtype == torch.uint8:
                pixels = device_rescale_normalize(pixels, spec)
            if queries is None and self._query_embeds is not None:
                queries = (self._query_embeds, None)
            out = self.model(pixels) if queries is None else self.model(pixels, *queries)
        logits = out["logits"]
        if self.built.postprocess == "softmax":
            return softmax_postprocess(logits, out["pred_boxes"], target_sizes)
        if self.built.postprocess == "sigmoid_max":
            return sigmoid_max_postprocess(logits, out["pred_boxes"], target_sizes)
        kk = min(self.built.num_top_queries, logits.shape[1] * logits.shape[2])
        return sigmoid_topk_postprocess(logits, out["pred_boxes"], target_sizes, k=kk)

    def _qset_queries(self, qset) -> tuple[torch.Tensor, torch.Tensor]:
        """`qset`'s (embeddings, mask) on the device, copied once per query
        set and kept (least recently used dropped past QSET_DEVICE_ENTRIES)
        so a repeated vocabulary pays no host-to-device copy. Called under
        the device lock."""
        hit = self._qset_tensors.get(qset.key)
        if hit is not None:
            self._qset_tensors.move_to_end(qset.key)
            return hit
        hit = (torch.from_numpy(qset.embeds).to(self.device),
               torch.from_numpy(qset.mask).to(self.device))
        self._qset_tensors[qset.key] = hit
        while len(self._qset_tensors) > QSET_DEVICE_ENTRIES:
            self._qset_tensors.popitem(last=False)
        return hit

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run every bucket of the ladder once ahead of traffic (cuDNN picks
        its algorithms and the kernel libraries build on the first call)."""
        h, w = self.built.preprocess_spec.input_hw
        dtype = torch.uint8 if self.device_preprocess else torch.float32
        for b in self.batch_buckets:
            pixels = torch.zeros((b, h, w, 3), dtype=dtype, device=self.device)
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
        are in each image's own pixel coordinates (OWLv2's: its padded
        square's). `canvas_hw` is the ragged scheduler's canvas: fixed-size
        specs ignore it, and a shortest-edge spec raises (the ragged canvas
        packing is not ported; the JAX package would stage into a smaller
        canvas and compute another result). `qset` (a
        `caching.text_cache.QuerySet`) runs an open-vocabulary model against
        that query set and labels from it; a closed-set family raises, as
        the JAX engine does.
        """
        if qset is not None and self.built.text_encoder is None:
            raise ValueError(
                f"{self.built.model_name} is a closed-set family: it has no "
                f"text encoder, so per-request `queries` are unsupported"
            )
        if canvas_hw is not None and self.built.preprocess_spec.mode == "shortest_edge":
            raise ValueError(RAGGED_SHORTEST_EDGE_ERROR)
        arrays = [as_uint8_rgb(img) for img in images]
        max_b = self.batch_buckets[-1]
        results: list[list[dict]] = []
        for start in range(0, len(arrays), max_b):
            chunk = arrays[start : start + max_b]
            try:
                results.extend(self._detect_chunk(chunk, qset))
            except Exception as exc:
                results.extend(self._recover_chunk(chunk, exc, qset))
        return results

    def _recover_chunk(
        self, chunk: list[np.ndarray], exc: Exception, qset=None
    ) -> list[list[dict]]:
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
                return self._detect_chunk(chunk, qset)
            mid = (len(chunk) + 1) // 2
            return self._detect_chunk(chunk[:mid], qset) + self._detect_chunk(chunk[mid:], qset)
        except Exception as retry_exc:
            raise as_typed(retry_exc) from retry_exc

    @torch.inference_mode()
    def _detect_chunk(self, chunk: list[np.ndarray], qset=None) -> list[list[dict]]:
        """Host preprocess, then (under the device lock) H2D, forward,
        postprocess and D2H, then thresholding on the host, for one chunk <=
        the top bucket."""
        t0 = time.monotonic()
        n = len(chunk)
        spec = self.built.preprocess_spec
        if self.device_preprocess:
            pixels, valid, sizes = batch_images_uint8(chunk, spec)
        else:
            pixels, sizes = batch_images_float(chunk, spec)
            valid = None
        bucket = self.bucket_for(n)
        if bucket > n:  # pad the batch to the static bucket size
            pad = bucket - n
            pixels = np.concatenate([pixels, np.zeros((pad, *pixels.shape[1:]), pixels.dtype)])
            sizes = np.concatenate([sizes, np.ones((pad, 2), np.float32)])
            if valid is not None:  # pad rows: the whole bucket, a mask of ones
                valid = np.concatenate([valid, np.tile(np.asarray([spec.input_hw], np.int32),
                                                       (pad, 1))])
        t_host = time.monotonic()
        with self._device_lock:
            args = [torch.from_numpy(pixels).to(self.device),
                    torch.from_numpy(sizes).to(self.device)]
            if qset is not None:
                args.append(self._qset_queries(qset))
            kwargs = {}
            if self.built.needs_mask:
                kwargs["valid"] = torch.from_numpy(valid).to(self.device)
            outputs = self._forward(*args, **kwargs)
            scores, labels, boxes = (t.cpu().numpy() for t in outputs)
        t_dev = time.monotonic()
        # a query set's detections label from its own (sorted) queries
        id2label = qset.id2label if qset is not None else self.built.id2label
        out = [
            to_detections(scores[j], labels[j], boxes[j], id2label, self.threshold)
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
