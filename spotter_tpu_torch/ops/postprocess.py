"""Detection postprocess (port of spotter_tpu.ops.postprocess: the sigmoid
top-k of RT-DETR, the softmax of YOLOS and the per-patch sigmoid max of
OWL-ViT).

The device side returns fixed-k (scores, labels, boxes) tensors; the host
thresholds them into the reference's detection dicts (`to_detections`).
"""

import os

import numpy as np
import torch

from spotter_tpu_torch.ops.boxes import center_to_corners, scale_boxes

# the JAX package's top-k selector; every valid value computes lax.top_k's
# result, which the stable sort below equals
TOPK_ENV = "SPOTTER_TPU_TOPK"


def topk_mode() -> str:
    """SPOTTER_TPU_TOPK, checked with the JAX package's values and text."""
    name = os.environ.get(TOPK_ENV, "auto").strip().lower()
    if name not in ("auto", "lax", "bisect"):
        raise ValueError(f"{TOPK_ENV} must be auto|lax|bisect, got {name!r}")
    return name


def stable_top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with `jax.lax.top_k`'s order: values
    descending, ties broken by the lower index. `torch.topk` promises no
    order among equal values, so this sorts stably and slices. A value of
    SPOTTER_TPU_TOPK outside auto|lax|bisect raises here, as the JAX
    package's top-k call does."""
    topk_mode()
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def sigmoid_topk_postprocess(
    logits: torch.Tensor,
    pred_boxes: torch.Tensor,
    target_sizes: torch.Tensor,
    k: int = 300,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RT-DETR-style postprocess.

    logits: (B, Q, C) raw class logits; pred_boxes: (B, Q, 4) normalized cxcywh;
    target_sizes: (B, 2) [h, w]. Returns scores (B, k), labels (B, k), boxes
    (B, k, 4) xyxy pixels — top-k over the flattened (query, class) axis.
    """
    b, q, c = logits.shape
    scores = torch.sigmoid(logits).reshape(b, q * c)
    top_scores, top_idx = stable_top_k(scores, k)
    labels = top_idx % c
    query_idx = top_idx // c
    boxes = torch.gather(pred_boxes, 1, query_idx[..., None].expand(-1, -1, 4))
    boxes = center_to_corners(boxes)
    boxes = scale_boxes(boxes, target_sizes.to(boxes.dtype))
    return top_scores, labels, boxes


def softmax_postprocess(
    logits: torch.Tensor,
    pred_boxes: torch.Tensor,
    target_sizes: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DETR/YOLOS-style postprocess.

    The final class is "no object" and is dropped before the per-query max
    and argmax (the first of equal maxima, as `jnp.argmax` takes it).
    Returns scores (B, Q), labels (B, Q), boxes (B, Q, 4) xyxy pixels.
    """
    probs = torch.softmax(logits, dim=-1)[..., :-1]
    scores = probs.amax(dim=-1)
    labels = probs.argmax(dim=-1)
    boxes = center_to_corners(pred_boxes)
    boxes = scale_boxes(boxes, target_sizes.to(boxes.dtype))
    return scores, labels, boxes


def sigmoid_max_postprocess(
    logits: torch.Tensor,
    pred_boxes: torch.Tensor,
    target_sizes: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """OWL-ViT-style postprocess: per patch, the sigmoid max over the text
    queries and its query index (the first of equal maxima, as `jnp.argmax`
    takes it). A masked query's NEG_INF logit has probability 0 and never
    wins over a real one. Returns scores (B, P), labels (B, P), boxes
    (B, P, 4) xyxy pixels."""
    probs = torch.sigmoid(logits)
    scores = probs.amax(dim=-1)
    labels = probs.argmax(dim=-1)
    boxes = center_to_corners(pred_boxes)
    boxes = scale_boxes(boxes, target_sizes.to(boxes.dtype))
    return scores, labels, boxes


def to_detections(
    scores: np.ndarray,
    labels: np.ndarray,
    boxes: np.ndarray,
    id2label: dict[int, str],
    threshold: float = 0.5,
) -> list[dict]:
    """Host-side: one image's fixed-k output -> thresholded detections.

    A list of {"label": str, "score": float, "box": [xmin, ymin, xmax, ymax]}
    dicts, the reference's threshold=0.5 filter and id2label lookup.
    """
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    boxes = np.asarray(boxes)
    keep = scores > threshold
    return [
        {
            "label": id2label[int(lbl)],
            "score": float(s),
            "box": [float(v) for v in box],
        }
        for s, lbl, box in zip(scores[keep], labels[keep], boxes[keep])
    ]
