"""Keys of the open-vocabulary query sets (the query-set half of
spotter_tpu.caching.keys, copied).

A query set is keyed order-insensitively: the text cache and the
scheduler's batch groups both key on sha256 over the SORTED queries, so
["dog", "couch"] and ["couch", "dog"] are one vocabulary. The URL and
content keys of the JAX package's result cache come with that cache.
"""

import hashlib


def queries_digest(queries) -> str:
    """Order-insensitive sha256 over an open-vocabulary query set."""
    joined = "\x1f".join(sorted(str(q) for q in queries))
    return hashlib.sha256(joined.encode("utf-8")).hexdigest()


def queries_key(model_name: str, queries) -> str:
    """Text-embedding cache key: `model|sha256(sorted queries)`."""
    return f"{model_name}|{queries_digest(queries)}"
