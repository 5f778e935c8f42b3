"""The one key-normalization module of the replica's data plane (the port's
copy of spotter_tpu.caching.keys).

Three layers hash the same identifiers and must never drift:

- the replica's content-addressed result cache keys detections on
  `(model, sha256(bytes), threshold bucket)` and its negative cache keys
  deterministic fetch failures on the URL (`url|<url>`);
- an edge router's rendezvous ring hashes the URL to pick the replica
  whose cache already holds that URL's result;
- the edge's negative verdict table is keyed by the same URL string the
  replica used when it recorded the verdict.

Every key here equals the JAX package's bit for bit, so an edge in front
of JAX replicas and port replicas alike hashes one string per URL.
Normalization is deliberately conservative: the replica caches under the
URL string it was asked to fetch, so the edge must hash the same string.

A query set is keyed order-insensitively: the text cache and the
scheduler's batch groups both key on sha256 over the SORTED queries, so
["dog", "couch"] and ["couch", "dog"] are one vocabulary.
"""

import hashlib


def normalize_url(url: str) -> str:
    """Canonical URL string for keying: whitespace-stripped, otherwise the
    exact string the replica will fetch."""
    return url.strip()


def affinity_key(url: str) -> str:
    """The edge router's rendezvous-hash key for a URL. The replica's
    negative-cache key for the same URL is `"url|" + this`."""
    return normalize_url(url)


def url_key(url: str) -> str:
    """Negative-cache key for a deterministic fetch failure (the URL is the
    only identity there is)."""
    return f"url|{normalize_url(url)}"


def queries_digest(queries) -> str:
    """Order-insensitive sha256 over an open-vocabulary query set."""
    joined = "\x1f".join(sorted(str(q) for q in queries))
    return hashlib.sha256(joined.encode("utf-8")).hexdigest()


def queries_key(model_name: str, queries) -> str:
    """Text-embedding cache key: `model|sha256(sorted queries)`."""
    return f"{model_name}|{queries_digest(queries)}"


def content_key(model_name: str, image_bytes: bytes, threshold: float) -> str:
    """The content-addressed key: model + sha256(bytes) + threshold bucket
    (2 decimals, so float formatting noise cannot split one deployment's
    key space)."""
    digest = hashlib.sha256(image_bytes).hexdigest()
    return f"{model_name}|{digest}|t{threshold:.2f}"
