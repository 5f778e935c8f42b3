"""Content-addressed result cache and single-flight coalescing (the port's
copy of spotter_tpu.caching's exports).

- `singleflight.SingleFlight`: N concurrent calls for one key share one
  flight, with per-waiter deadlines;
- `result_cache.ResultCache`: an LRU over post-processed detections keyed
  on (model, sha256(image bytes), threshold bucket), with TTL, a byte
  budget, and a short-TTL negative cache for deterministic failures;
- `keys`: the one key-normalization module (the edge's affinity key and
  the replica's cache keys).

The tier is opt-in: `SPOTTER_TPU_CACHE_MAX_MB=0` (the default) builds none
of it. Exports are lazy (PEP 562), so importing the package pulls in
nothing heavy.
"""

_EXPORTS = {
    "SingleFlight": "spotter_tpu_torch.caching.singleflight",
    "ResultCache": "spotter_tpu_torch.caching.result_cache",
    "CACHE_MAX_MB_ENV": "spotter_tpu_torch.caching.result_cache",
    "CACHE_TTL_ENV": "spotter_tpu_torch.caching.result_cache",
    "CACHE_NEGATIVE_TTL_ENV": "spotter_tpu_torch.caching.result_cache",
    "CACHE_ANNOTATED_ENV": "spotter_tpu_torch.caching.result_cache",
    "content_key": "spotter_tpu_torch.caching.keys",
    "url_key": "spotter_tpu_torch.caching.keys",
    "affinity_key": "spotter_tpu_torch.caching.keys",
    "normalize_url": "spotter_tpu_torch.caching.keys",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)
