"""The port's binary wire format and data-plane headers
(`spotter_tpu_torch.serving.wire`) against the JAX package's
(`spotter_tpu.serving.wire`), on the same seeded inputs.

Held: `encode_frame` of seeded response bodies is byte-equal to JAX's (v2
with CRCs, and v1 with `SPOTTER_TPU_WIRE_CRC=0`), and each package decodes
the other's frames back to the body; every truncation and a bit flip at
every byte raise the same `FrameError` / `FrameCorruptError` types with the
same texts as JAX's; `summarize_cache_outcomes`, the negative header,
`wants_frame` and `to_json_bytes` give JAX's answers, and the JAX edge
reads the port replica's negative header as it reads JAX's (the edge's
half of the module comes with the fleet tier).
"""

import base64
import itertools

import numpy as np
import pytest

from spotter_tpu.serving import wire as jwire
from spotter_tpu_torch.serving import wire


def _body(seed: int) -> dict:
    """A /detect response shape: successes with JPEG-like payloads, errors,
    and sometimes the `degraded` marker."""
    rng = np.random.default_rng(seed)
    images = []
    for i in range(int(rng.integers(1, 6))):
        url = f"http://cdn.example/{seed}/{i}.jpg"
        if rng.uniform() < 0.25:
            images.append({"url": url, "error": f"HTTP Error: Client error '404' {i}"})
            continue
        dets = [{"label": ["TV", "Bed", "Oven"][int(rng.integers(0, 3))],
                 "box": [float(v) for v in np.round(rng.uniform(0, 640, 4), 3)]}
                for _ in range(int(rng.integers(0, 4)))]
        payload = rng.integers(0, 256, int(rng.integers(0, 3000)), dtype=np.uint8).tobytes()
        images.append({"url": url, "detections": dets,
                       "labeled_image_base64": base64.b64encode(payload).decode("ascii")})
    body = {"amenities_description": "The property contains: Bed, TV.", "images": images}
    if seed % 3 == 0:
        body["degraded"] = ["stale"]
    return body


SEEDS = range(6)


@pytest.mark.parametrize("seed", SEEDS)
def test_frame_bytes_equal_jax_and_cross_decode(seed, monkeypatch):
    body = _body(seed)
    frame = wire.encode_frame(body)
    assert frame == jwire.encode_frame(body)
    assert jwire.decode_frame(frame) == body and wire.decode_frame(jwire.encode_frame(body)) == body
    assert wire.to_json_bytes(wire.decode_frame(frame)) == jwire.to_json_bytes(body)
    monkeypatch.setenv(wire.WIRE_CRC_ENV, "0")
    v1 = wire.encode_frame(body)
    assert v1 == jwire.encode_frame(body) and v1[4] == wire.FRAME_VERSION_V1
    assert jwire.decode_frame(v1) == wire.decode_frame(v1) == body


def _outcome(decode, data):
    try:
        return ("ok", decode(data))
    except wire.FrameError as exc:
        return (type(exc).__name__, str(exc))
    except jwire.FrameError as exc:
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("seed", SEEDS)
def test_damaged_frames_raise_as_jax(seed):
    frame = wire.encode_frame(_body(seed))
    rng = np.random.default_rng(seed + 100)
    cuts = sorted(set(range(0, 40)) | {int(c) for c in rng.integers(0, len(frame), 20)})
    damaged = [frame[:c] for c in cuts if c < len(frame)]
    for i in range(len(frame)):
        bit = 1 << int(rng.integers(0, 8))
        damaged.append(frame[:i] + bytes([frame[i] ^ bit]) + frame[i + 1:])
    kinds = set()
    for data in damaged:
        port, jax = _outcome(wire.decode_frame, data), _outcome(jwire.decode_frame, data)
        assert port == jax
        assert port[0] != "ok" or port[1] == _body(seed)
        kinds.add(port[0])
        if port[0] != "ok":
            with pytest.raises(wire.FrameError):
                wire.verify_frame(data)
    assert {"FrameError", "FrameCorruptError"} <= kinds


OUTCOMES = ("hit", "miss", "negative", "coalesced", None, "")


def test_cache_summary_and_negative_header_as_jax():
    for n in range(4):
        for combo in itertools.product(OUTCOMES, repeat=n):
            assert wire.summarize_cache_outcomes(combo) == jwire.summarize_cache_outcomes(combo)
    rng = np.random.default_rng(7)
    for _ in range(20):
        verdicts = {
            f"http://cdn/{int(rng.integers(1000))} a?b=c,d;e": {
                "kind": ["fetch", "poison"][int(rng.integers(0, 2))],
                "error": "HTTP Error: Client error '404 Not Found' ; , = " * int(rng.integers(1, 8)),
                "ttl_s": float(rng.uniform(-1, 60)),
            } for _ in range(int(rng.integers(0, 4)))
        }
        header = wire.encode_negative_header(verdicts)
        assert header == jwire.encode_negative_header(verdicts)
    for accept in (None, "", "application/json", "Application/X-Spotter-Frame, */*"):
        assert wire.wants_frame(accept) == jwire.wants_frame(accept)
    assert (wire.REPLICA_HEADER, wire.VERSION_HEADER, wire.X_CACHE_HEADER, wire.NEGATIVE_HEADER) == (
        jwire.REPLICA_HEADER, jwire.VERSION_HEADER, jwire.X_CACHE_HEADER, jwire.NEGATIVE_HEADER)


def test_jax_edge_folds_the_port_replicas_negative_header():
    """A JAX edge in front of a port replica: its verdict table fills from
    the port's `X-Spotter-Negative` value exactly as from JAX's, and forgets
    each verdict at the replica's TTL."""

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    verdicts = {" http://a ": {"kind": "fetch", "error": "e ; , =", "ttl_s": 9},
                "http://b": {"kind": "poison", "error": "p", "ttl_s": 2},
                "http://d": {"kind": "fetch", "error": "gone", "ttl_s": 0}}
    clock, jclock = Clock(), Clock()
    edges = (jwire.EdgeNegativeCache(clock=clock), jwire.EdgeNegativeCache(clock=jclock))
    headers = (wire.encode_negative_header(verdicts), jwire.encode_negative_header(verdicts))
    assert [e.absorb(h) for e, h in zip(edges, headers)] == [2, 2]
    for dt in (0.0, 3.0, 7.0):
        clock.t += dt
        jclock.t += dt
        for url in ("http://a", "http://b", "http://c", "http://d"):
            assert edges[0].get(url) == edges[1].get(url)
        assert edges[0].snapshot() == edges[1].snapshot()
    assert edges[0].snapshot()["hits_total"] == 3  # a, b at 0 s; a at 3 s
