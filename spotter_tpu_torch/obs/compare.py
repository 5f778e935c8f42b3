"""Detection-diff comparator (the port's own copy of
spotter_tpu.obs.compare): one definition of "the same answer" for every
subsystem that asks whether two answers agree (the golden probe here; the
edge's quorum sampler and the rollout shadow lane with the fleet tier).

Two modes:

- `norm_detections()`: per-image sorted (label, 2dp-score) pairs. Cheap,
  order-invariant, good enough for diff-rate counting over a window.
- `images_equivalent()` / `detections_equivalent()`: tolerance-based
  per-detection matching. Rounding has a boundary problem (0.494 vs 0.496
  round to 0.49 vs 0.50), which is unacceptable when one comparison can
  start an exit, so this pairs detections within `score_tol` / `box_tol`:
  near-threshold score flutter and sub-pixel box noise never read as
  disagreement, while a flipped label, a missing detection or a displaced
  box always does.

Pure stdlib.
"""

from __future__ import annotations

# Score flutter under 0.05 is decode/accumulation noise on identical
# weights; a real corruption moves scores by far more (or changes the label
# set). Boxes are in pixels: 2 px absorbs resize jitter, not a displaced box.
DEFAULT_SCORE_TOL = 0.05
DEFAULT_BOX_TOL = 2.0


def norm_detections(images) -> list:
    """Canonical per-image detection view: sorted (label, 2dp-score) pairs,
    stable under detection ordering and float noise."""
    out = []
    for img in images or []:
        dets = img.get("detections") if isinstance(img, dict) else None
        out.append(
            sorted(
                (str(d.get("label")), round(float(d.get("score", 0.0)), 2))
                for d in (dets or [])
                if isinstance(d, dict)
            )
        )
    return out


def _clean(dets) -> list[dict]:
    return [d for d in (dets or []) if isinstance(d, dict)]


def _score(d: dict) -> float:
    try:
        return float(d.get("score", 0.0))
    except (TypeError, ValueError):
        return 0.0


def _box(d: dict) -> list[float] | None:
    box = d.get("box")
    if not isinstance(box, (list, tuple)) or len(box) != 4:
        return None
    try:
        return [float(v) for v in box]
    except (TypeError, ValueError):
        return None


def _matches(a: dict, b: dict, score_tol: float, box_tol: float) -> bool:
    if abs(_score(a) - _score(b)) > score_tol:
        return False
    box_a, box_b = _box(a), _box(b)
    if box_a is None or box_b is None:
        # a detection without a well-formed box matches only another
        # box-less detection: a box appearing or vanishing is a real diff
        return box_a is None and box_b is None
    return all(abs(x - y) <= box_tol for x, y in zip(box_a, box_b))


def detections_equivalent(
    a,
    b,
    *,
    score_tol: float = DEFAULT_SCORE_TOL,
    box_tol: float = DEFAULT_BOX_TOL,
) -> bool:
    """True when two detection lists are the same answer up to tolerance:
    every detection in `a` pairs with a distinct same-label detection in `b`
    within `score_tol` and per-coordinate `box_tol`, and none are left over.
    Order-invariant on both sides (greedy matching over a score-sorted
    pool)."""
    a, b = _clean(a), _clean(b)
    if len(a) != len(b):
        return False
    remaining = sorted(b, key=_score)
    for det in sorted(a, key=_score):
        label = str(det.get("label"))
        hit = -1
        for i, cand in enumerate(remaining):
            if str(cand.get("label")) != label:
                continue
            if _matches(det, cand, score_tol, box_tol):
                hit = i
                break
        if hit < 0:
            return False
        remaining.pop(hit)
    return not remaining


def images_equivalent(
    a_images,
    b_images,
    *,
    score_tol: float = DEFAULT_SCORE_TOL,
    box_tol: float = DEFAULT_BOX_TOL,
) -> bool:
    """Per-image tolerance comparison of two /detect `images` arrays."""
    a_images = a_images or []
    b_images = b_images or []
    if len(a_images) != len(b_images):
        return False
    for img_a, img_b in zip(a_images, b_images):
        dets_a = img_a.get("detections") if isinstance(img_a, dict) else None
        dets_b = img_b.get("detections") if isinstance(img_b, dict) else None
        if not detections_equivalent(
            dets_a, dets_b, score_tol=score_tol, box_tol=box_tol
        ):
            return False
    return True


def diff_detections(
    expected,
    actual,
    *,
    score_tol: float = DEFAULT_SCORE_TOL,
    box_tol: float = DEFAULT_BOX_TOL,
) -> str | None:
    """None when equivalent, else a short human-readable reason: the string
    that lands in the pinned flight-recorder trace when a probe comparison
    fails, so the record says what disagreed."""
    expected, actual = _clean(expected), _clean(actual)
    if len(expected) != len(actual):
        return f"count {len(actual)} != expected {len(expected)}"
    if detections_equivalent(
        expected, actual, score_tol=score_tol, box_tol=box_tol
    ):
        return None
    exp_labels = sorted(str(d.get("label")) for d in expected)
    act_labels = sorted(str(d.get("label")) for d in actual)
    if exp_labels != act_labels:
        return f"labels {act_labels} != expected {exp_labels}"
    return (
        f"score/box outside tol (score_tol={score_tol}, box_tol={box_tol}): "
        f"{actual} != expected {expected}"
    )
