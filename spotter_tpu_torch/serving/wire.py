"""Binary wire format and data-plane headers of the /detect path (the port's
copy of the replica's half of spotter_tpu.serving.wire).

JSON with base64 images stays the default, byte-identical when nothing is
negotiated. A client or edge that sends

    Accept: application/x-spotter-frame

gets the same response as a length-prefixed binary frame: the JSON body
with every `labeled_image_base64` string swapped for an `image_segment`
index into raw JPEG segments appended after the header, and the header
deflated against a preset dictionary (only the header: raw JPEG does not
compress).

Frame layout (integers big-endian), version 2 with checksums; version 1
frames (no checksums) still parse, and `SPOTTER_TPU_WIRE_CRC=0` makes the
encoder emit v1 for peers without checksums:

    offset  size  field
    0       4     magic "SPTF"
    4       1     version (2; the decoder also accepts 1)
    5       1     flags (bit 0: header is deflated; bit 1: preset dict)
    6       2     reserved (0)
    8       4     segment count N
    12      4     header length H
    16      4     header checksum (v2 only; CRC over the preamble + H bytes)
    20      H     header JSON (per flags, possibly deflated)
    20+H    ...   N segments, each: u32 length + u32 checksum + raw bytes
                  (v1 segments carry no checksum)

The checksum is `zlib.crc32` (CRC-32/ISO-HDLC); the polynomial and the
preset dictionary are part of the wire contract, so the port's frames are
byte-equal to the JAX package's and each decodes the other's. A damaged
frame raises `FrameCorruptError` (a checksum) or `FrameError` (structure),
never a garbage decode.

The header JSON is the `DetectionResponse.model_dump(exclude_none=True)`
dict with `"image_segment": <idx>` in place of each success image's
`"labeled_image_base64"`, so `decode_frame(encode_frame(x)) == x`, and
`to_json_bytes` re-serializes a decoded frame to the default JSON bytes.

Also here, the additive headers: `X-Cache: hit|miss|negative|coalesced`
(a multi-image request summarizes: any negative -> "negative", all hits ->
"hit", hits and coalesced -> "coalesced", else "miss"); `X-Spotter-Negative`
(the replica's deterministic-failure verdicts, `u=<url>;k=<kind>;t=<ttl>;
e=<error>` items, comma-joined, which an edge folds into its verdict
table); `X-Spotter-Replica` and `X-Spotter-Version` (which replica and
build produced a response). The edge's half (the fan-in merge, the header
parse and the verdict table) comes with the fleet tier that calls it.

Stdlib-only.
"""

import base64
import json
import os
import struct
import zlib
from urllib.parse import quote

FRAME_CONTENT_TYPE = "application/x-spotter-frame"
FRAME_MAGIC = b"SPTF"
FRAME_VERSION = 2  # v2: header + per-segment checksums
FRAME_VERSION_V1 = 1  # still parsed; emitted when SPOTTER_TPU_WIRE_CRC=0
_FLAG_DEFLATED = 0x01  # header is zlib-compressed
_FLAG_DICT = 0x02  # header is RAW deflate against the preset dictionary
_HEAD = struct.Struct(">4sBBHII")  # magic, version, flags, reserved, nseg, hlen
_U32 = struct.Struct(">I")

WIRE_CRC_ENV = "SPOTTER_TPU_WIRE_CRC"


def _crc(data: bytes) -> int:
    """The frame checksum (see the module docstring for why CRC-32 over
    CRC32C here): zlib's C implementation, masked to u32."""
    return zlib.crc32(data) & 0xFFFFFFFF


def crc_enabled() -> bool:
    """Frame checksums are the default; SPOTTER_TPU_WIRE_CRC=0 emits
    checksum-less v1 frames (decoding always accepts both versions)."""
    return os.environ.get(WIRE_CRC_ENV, "1").strip() not in ("", "0")

# Preset deflate dictionary (the SPDY header-dict trick): the response
# vocabulary is fixed protocol-side, so seeding the compressor with it
# roughly halves the compressed header for small responses — which is what
# pushes the total frame saving past the bare ~25% base64 tax even for
# single-image responses. Changing this dictionary is a WIRE CHANGE: bump
# FRAME_VERSION with it.
FRAME_ZDICT = json.dumps(
    {
        "amenities_description": (
            "The property contains: No relevant amenities detected."
        ),
        "images": [
            {
                "url": "https://http://",
                "detections": [{"label": "", "box": []}],
                "image_segment": 0,
                "error": (
                    "Fetch Error: HTTP Error: Processing Error: "
                    "Deadline exceeded: Overloaded: "
                ),
            }
        ],
        "degraded": ["stale", "bucket_cap", "threshold"],
    },
    separators=(",", ":"),
).encode("utf-8")

X_CACHE_HEADER = "X-Cache"
NEGATIVE_HEADER = "X-Spotter-Negative"
# Which replica produced this response: the identity stamp (`replica_id`
# from /metrics) echoed as a header at the replica and forwarded by the edge, so any slow or corrupt response joins
# /debug/fleet rows and stitched traces by replica id without scraping.
# Fan-in responses carry every contributing replica, comma-joined.
REPLICA_HEADER = "X-Spotter-Replica"
# Which deploy version produced this response: the identity
# stamp's build version echoed at the replica and forwarded by the edge
# (fan-in responses carry every distinct contributing version,
# comma-joined). The pool learns per-replica versions from this header —
# the substrate for mixed-version replay/hedge pinning and the rollout
# verdict's canary-vs-baseline split.
VERSION_HEADER = "X-Spotter-Version"

# cap the per-verdict error text: headers are not a payload channel
_MAX_ERROR_CHARS = 200


class FrameError(ValueError):
    """Malformed frame (bad magic/version, truncated segment, bad index)."""


class FrameCorruptError(FrameError):
    """A frame whose bytes fail their checksum (header or segment): the
    payload was damaged in transit or at rest. Distinct from FrameError so
    the edge can count corruption separately and treat it as a transport
    failure of the replica that produced it (replay on the next ranked
    holder) rather than a protocol bug."""


def wants_frame(accept: str | None) -> bool:
    """Content negotiation: the frame is opt-in per request via Accept."""
    return bool(accept) and FRAME_CONTENT_TYPE in accept.lower()


def to_json_bytes(body: dict) -> bytes:
    """The default wire encoding — byte-identical to what
    `aiohttp.web.json_response(body)` puts on the socket (plain
    `json.dumps`), so a frame-decoded response re-encodes to exactly the
    bytes a non-negotiating client would have received."""
    return json.dumps(body).encode("utf-8")


# -- frame encode/decode -----------------------------------------------------


def strip_segments(body: dict) -> tuple[dict, list[bytes]]:
    """(header, segments): every success image's base64 payload decoded out
    into a raw segment, the image dict rewritten with `image_segment`. The
    input dict is not mutated."""
    segments: list[bytes] = []
    header = dict(body)
    images = []
    for img in body.get("images", ()):
        b64 = img.get("labeled_image_base64") if isinstance(img, dict) else None
        if b64 is None:
            images.append(img)
            continue
        out = {k: v for k, v in img.items() if k != "labeled_image_base64"}
        out["image_segment"] = len(segments)
        segments.append(base64.b64decode(b64))
        images.append(out)
    header["images"] = images
    return header, segments


def restore_segments(header: dict, segments: list[bytes]) -> dict:
    """Inverse of `strip_segments`: base64 back in, `image_segment` gone."""
    body = dict(header)
    images = []
    for img in header.get("images", ()):
        idx = img.get("image_segment") if isinstance(img, dict) else None
        if idx is None:
            images.append(img)
            continue
        if not isinstance(idx, int) or not 0 <= idx < len(segments):
            raise FrameError(f"image_segment {idx!r} out of range")
        out = {k: v for k, v in img.items() if k != "image_segment"}
        out["labeled_image_base64"] = base64.b64encode(
            segments[idx]
        ).decode("utf-8")
        images.append(out)
    body["images"] = images
    return body


def build_frame(
    header: dict, segments: list[bytes], crc: bool | None = None
) -> bytes:
    """Serialize an already-split (header, segments) pair. The header is
    deflated when that actually shrinks it (it always does for real
    responses; tiny test fixtures may not). `crc` (default
    `SPOTTER_TPU_WIRE_CRC`) selects the v2 checksummed layout; False emits
    a checksum-less v1 frame for pre-checksum peers."""
    if crc is None:
        crc = crc_enabled()
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    co = zlib.compressobj(9, zlib.DEFLATED, -15, zdict=FRAME_ZDICT)
    deflated = co.compress(raw) + co.flush()
    flags = 0
    if len(deflated) < len(raw):
        raw, flags = deflated, _FLAG_DEFLATED | _FLAG_DICT
    version = FRAME_VERSION if crc else FRAME_VERSION_V1
    head = _HEAD.pack(FRAME_MAGIC, version, flags, 0, len(segments), len(raw))
    parts = [head]
    if crc:
        # the header checksum covers the fixed preamble too, so a flipped
        # bit in flags/reserved/counts is caught even where the structure
        # would still parse
        parts.append(_U32.pack(_crc(head + raw)))
    parts.append(raw)
    for seg in segments:
        parts.append(_U32.pack(len(seg)))
        if crc:
            parts.append(_U32.pack(_crc(seg)))
        parts.append(seg)
    return b"".join(parts)


def split_frame(data: bytes) -> tuple[dict, list[bytes]]:
    """Parse a frame into (header, segments) without touching base64 — the
    router's merge path re-frames segments as-is. Raises FrameError on any
    structural damage (truncation, bad magic/version/JSON) and
    FrameCorruptError when a v2 checksum does not match its bytes — never
    struct.error/KeyError/UnicodeDecodeError, and never a garbage decode
    (the fuzz contract, tests/test_wire.py)."""
    if len(data) < _HEAD.size:
        raise FrameError(f"frame truncated at {len(data)} bytes")
    magic, version, flags, _, nseg, hlen = _HEAD.unpack_from(data, 0)
    if magic != FRAME_MAGIC:
        raise FrameError(f"bad frame magic {magic!r}")
    if version not in (FRAME_VERSION_V1, FRAME_VERSION):
        raise FrameError(f"unsupported frame version {version}")
    checked = version >= FRAME_VERSION
    off = _HEAD.size
    header_crc = None
    if checked:
        if len(data) < off + _U32.size:
            raise FrameError("frame header checksum truncated")
        (header_crc,) = _U32.unpack_from(data, off)
        off += _U32.size
    if hlen > len(data) - off:
        raise FrameError("frame header truncated")
    raw = data[off:off + hlen]
    off += hlen
    if header_crc is not None:
        got = _crc(data[: _HEAD.size] + raw)
        if got != header_crc:
            raise FrameCorruptError(
                f"frame header checksum mismatch "
                f"(expected {header_crc:#010x}, got {got:#010x})"
            )
    if flags & _FLAG_DEFLATED:
        try:
            if flags & _FLAG_DICT:
                do = zlib.decompressobj(-15, zdict=FRAME_ZDICT)
                raw = do.decompress(raw) + do.flush()
            else:
                raw = zlib.decompress(raw)
        except zlib.error as exc:
            raise FrameError(f"bad deflated header: {exc}") from None
    try:
        header = json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError) as exc:
        raise FrameError(f"bad header JSON: {exc}") from None
    if not isinstance(header, dict):
        raise FrameError("frame header is not an object")
    segments: list[bytes] = []
    for _ in range(nseg):
        if len(data) < off + _U32.size:
            raise FrameError("frame segment table truncated")
        (seg_len,) = _U32.unpack_from(data, off)
        off += _U32.size
        seg_crc = None
        if checked:
            if len(data) < off + _U32.size:
                raise FrameError("frame segment checksum truncated")
            (seg_crc,) = _U32.unpack_from(data, off)
            off += _U32.size
        if seg_len > len(data) - off:
            raise FrameError("frame segment truncated")
        seg = data[off:off + seg_len]
        off += seg_len
        if seg_crc is not None and _crc(seg) != seg_crc:
            raise FrameCorruptError(
                f"frame segment {len(segments)} checksum mismatch "
                f"(expected {seg_crc:#010x}, got {_crc(seg):#010x})"
            )
        segments.append(seg)
    return header, segments


def verify_frame(data: bytes) -> None:
    """Full structural + checksum validation of a frame, result discarded:
    the replica-pool `validator` hook's body (the router passes this over
    frame-typed sub-responses so a corrupt frame is replayed like a
    transport failure)."""
    split_frame(data)


def encode_frame(body: dict) -> bytes:
    """JSON-shaped response dict (base64 images) -> frame bytes."""
    header, segments = strip_segments(body)
    return build_frame(header, segments)


def decode_frame(data: bytes) -> dict:
    """Frame bytes -> the JSON-shaped response dict (base64 restored)."""
    return restore_segments(*split_frame(data))


# -- X-Cache summary ---------------------------------------------------------


def summarize_cache_outcomes(outcomes) -> str | None:
    """One `X-Cache` value for a (possibly multi-image) request; None when
    the caching tier produced no observation (tier off)."""
    seen = [o for o in outcomes if o]
    if not seen:
        return None
    if "negative" in seen:
        return "negative"
    if all(o == "hit" for o in seen):
        return "hit"
    if "coalesced" in seen and all(o in ("hit", "coalesced") for o in seen):
        return "coalesced"
    return "miss"


# -- negative-verdict header -------------------------------------------------


def encode_negative_header(verdicts: dict[str, dict]) -> str | None:
    """{url: {"kind", "ttl_s", "error"}} -> header value (None when empty)."""
    items = []
    for url, v in verdicts.items():
        err = str(v.get("error", ""))[:_MAX_ERROR_CHARS]
        items.append(
            f"u={quote(url, safe='')};k={v.get('kind', 'fetch')}"
            f";t={float(v.get('ttl_s', 0.0)):.1f};e={quote(err, safe='')}"
        )
    return ", ".join(items) if items else None
