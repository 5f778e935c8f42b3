"""COCO label tables for the offline/tiny model paths (copy of
spotter_tpu.models.coco, kept here so the port imports nothing of the JAX
package).

Real checkpoints carry id2label in their HF config (that is what the engine
uses — serve.py:111-114 semantics). These tables back the no-network tiny
models and synthetic benchmarks.
"""

COCO_LABELS_80: tuple[str, ...] = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train", "truck",
    "boat", "traffic light", "fire hydrant", "stop sign", "parking meter", "bench",
    "bird", "cat", "dog", "horse", "sheep", "cow", "elephant", "bear", "zebra",
    "giraffe", "backpack", "umbrella", "handbag", "tie", "suitcase", "frisbee",
    "skis", "snowboard", "sports ball", "kite", "baseball bat", "baseball glove",
    "skateboard", "surfboard", "tennis racket", "bottle", "wine glass", "cup",
    "fork", "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair", "couch",
    "potted plant", "bed", "dining table", "toilet", "tv", "laptop", "mouse",
    "remote", "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)

# COCO's original 91-id space (DETR/YOLOS head size); gaps are "N/A".
_GAPS = {0, 12, 26, 29, 30, 45, 66, 68, 69, 71, 83}


def coco_id2label_80() -> dict[int, str]:
    return dict(enumerate(COCO_LABELS_80))


def coco_id2label_91() -> dict[int, str]:
    out: dict[int, str] = {}
    it = iter(COCO_LABELS_80)
    for i in range(91):
        out[i] = "N/A" if i in _GAPS else next(it)
    return out
