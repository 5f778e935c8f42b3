"""Response assembly for /detect (port of the assembly half of
spotter_tpu.serving.detector).

Turns the engine's per-image detections into the reference wire shape, as
plain dicts: each detection's COCO label goes through AMENITIES_MAPPING
(labels outside it are dropped), and the response carries the sorted
amenity set as `amenities_description`. Fetching, decoding, drawing the
labeled image (`labeled_image_base64`), the batcher and the HTTP server
are not ported yet; callers hand in the engine's detections.
"""

from typing import Sequence

from spotter_tpu_torch.taxonomy import AMENITIES_MAPPING


def amenity_detections(raw_detections: list[dict]) -> list[dict]:
    """Engine detections -> [{"label": amenity, "box": [x0, y0, x1, y1]}],
    in the engine's order, keeping only labels the taxonomy maps."""
    out = []
    for det in raw_detections:
        amenity = AMENITIES_MAPPING.get(det["label"])
        if amenity is not None:
            out.append({"label": amenity, "box": list(det["box"])})
    return out


def amenities_description(images: list[dict]) -> str:
    """The reference's summary sentence over every image's amenities."""
    amenities = {d["label"] for img in images for d in img.get("detections", ())}
    if not amenities:
        return "No relevant amenities detected."
    return f"The property contains: {', '.join(sorted(amenities))}."


def assemble_response(urls: Sequence[str], raw_per_image: list[list[dict]]) -> dict:
    """Per-image engine detections -> {"amenities_description", "images"}."""
    if len(urls) != len(raw_per_image):
        raise ValueError(f"{len(urls)} urls but {len(raw_per_image)} detection lists")
    images = [
        {"url": url, "detections": amenity_detections(raw)}
        for url, raw in zip(urls, raw_per_image)
    ]
    return {"amenities_description": amenities_description(images), "images": images}
