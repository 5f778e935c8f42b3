"""Amenity taxonomy: COCO detection labels -> amenity names (copy of
spotter_tpu.taxonomy, kept here so the port imports nothing of the JAX
package).

Behavior contract with the reference (apps/spotter/src/spotter/serve.py:31-59):
the same 22 COCO labels map to the same amenity strings; labels outside the
mapping are dropped from results (serve.py:123-126).
"""

# Wire-contract constant: every key/value pair must match the reference
# exactly (changing one changes /detect responses). Rough grouping: appliance
# and tableware classes signal a kitchen (tableware collapses to the generic
# "kitchen" string; "sink" is ambiguous between kitchen and bathroom and is
# reported as itself); furniture classes map to living/bedroom amenities
# with two renames (couch->sofa, tv->TV); "toilet" stands in for a bathroom
# and desk-peripheral classes for a workspace; "car" is read as parking.
AMENITIES_MAPPING: dict[str, str] = {
    "refrigerator": "refrigerator",
    "oven": "oven",
    "microwave": "microwave",
    "sink": "sink",
    "dining table": "dining area",
    "toaster": "toaster",
    "wine glass": "kitchen",
    "cup": "kitchen",
    "fork": "kitchen",
    "knife": "kitchen",
    "spoon": "kitchen",
    "bowl": "kitchen",
    "tv": "TV",
    "couch": "sofa",
    "chair": "chair",
    "bed": "bed",
    "toilet": "bathroom",
    "hair drier": "hair dryer",
    "laptop": "workspace",
    "mouse": "workspace",
    "keyboard": "workspace",
    "car": "parking",
}


def amenity_for_label(label: str) -> str | None:
    """Return the amenity name for a detector class label, or None if irrelevant."""
    return AMENITIES_MAPPING.get(label)
