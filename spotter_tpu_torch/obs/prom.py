"""Prometheus text-exposition view over the JSON `/metrics` snapshot (the
port's own copy of spotter_tpu.obs.prom).

The JSON `/metrics` blob stays as it is; this module renders the same dict
as Prometheus text exposition (version 0.0.4 line format) when a scraper
asks via `Accept: text/plain` or `?format=prometheus`:

- `*_total` leaves become counters, numeric leaves gauges, bools 0/1
  gauges, string leaves `name{value="..."} 1` info-style gauges;
- nested dicts flatten with `_` joins, except two-level numeric maps under
  a labeled key (`pool_size`, `time_to_ready_s`, ...), which render with
  labels, and lists of per-replica dicts, which label by `{url="..."}`;
- the snapshot's `latency_ms_histogram` renders as a real histogram, with
  OpenMetrics-style trace-id exemplars on the buckets: the metrics-traces
  join the flight recorder exists to serve;
- quantile-summary dicts (`slack_at_dispatch_ms`) render as a Prometheus
  summary with `{quantile="..."}` labels.
"""

import math

PREFIX = "spotter_tpu"
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# keys whose dict values are {label_value: number} or {label_value: {...}}
# and read better as labels than as name suffixes
_LABELED_KEYS = {
    "pool_size": ("pool", "state"),
    "time_to_ready_s": ("pool",),
    "requests_total": ("class",),
    "failures_total": ("class",),
    "admit_sheds_total": ("class",),
    # burn rate labeled by window
    # (fast = 1 m, slow = 30 m) and HBM gauges labeled per device
    "slo_burn_rate": ("window",),
    "hbm_per_device": ("device", "stat"),
    # one counter per rollout outcome
    "rollouts_total": ("verdict",),
    # desired-vs-observed gap per pool
    "drift": ("pool",),
    # bounded top-K per-tenant rows:
    # tenants{tenant="acme",stat="admits_total"} ... cardinality is capped
    # by the plane's top_k + "other" overflow bucket, never by scrape luck
    "tenants": ("tenant", "stat"),
}
# keys whose dict values are {"p50": x, "p90": y, ...} quantile summaries
# (the engine snapshot's slack_at_dispatch_ms), rendered as a
# Prometheus summary with {quantile="0.5"} labels instead of flattened
# name suffixes
_SUMMARY_KEYS = {"slack_at_dispatch_ms"}
_QUANTILE_TAGS = {"p50": "0.5", "p90": "0.9", "p99": "0.99"}

# snapshot keys handled specially (never via the generic walk), plus the
# capture-shape table, a per-shape list for /debug/perf and the JSON view
# whose aggregates the exposition carries, and the raw merge substrate a
# fleet aggregator reads (JSON-only)
_SKIP_KEYS = {
    "latency_ms_histogram", "pools", "dp_degraded", "compile_shapes",
    "stage_ms_histogram", "slo_burn_raw", "perf_raw", "replica",
}


def _name(*parts: str) -> str:
    out = "_".join(p for p in parts if p)
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in out)


def _fmt(value: float) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, float):
        if math.isinf(value):
            return "+Inf" if value > 0 else "-Inf"
        return repr(value)
    return str(value)


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(pairs: dict[str, str]) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in pairs.items())
    return "{" + inner + "}"


class _Emitter:
    def __init__(self) -> None:
        self.samples: dict[str, list[tuple[dict, str, str]]] = {}
        self.types: dict[str, str] = {}

    def add(self, name: str, labels: dict, value, mtype: str,
            exemplar: str = "") -> None:
        if value is None:
            return
        self.samples.setdefault(name, []).append(
            (labels, _fmt(value), exemplar)
        )
        self.types.setdefault(name, mtype)

    def render(self) -> str:
        lines: list[str] = []
        for name, rows in self.samples.items():
            lines.append(f"# TYPE {name} {self.types[name]}")
            for labels, value, exemplar in rows:
                lines.append(f"{name}{_labels(labels)} {value}{exemplar}")
        return "\n".join(lines) + "\n"


def _type_for(key: str) -> str:
    return "counter" if key.endswith("_total") else "gauge"


def _walk(em: _Emitter, prefix: str, key: str, value) -> None:
    if key in _SKIP_KEYS:
        return
    name = _name(prefix, key)
    if isinstance(value, bool):
        em.add(name, {}, int(value), "gauge")
    elif isinstance(value, (int, float)):
        em.add(name, {}, value, _type_for(key))
    elif isinstance(value, str):
        em.add(_name(name, "info"), {"value": value}, 1, "gauge")
    elif isinstance(value, dict):
        labels = _LABELED_KEYS.get(key)
        if key in _SUMMARY_KEYS:
            for tag, v in value.items():
                q = _QUANTILE_TAGS.get(tag)
                if q is not None and isinstance(v, (int, float)):
                    em.add(name, {"quantile": q}, v, "summary")
        elif labels is not None:
            _walk_labeled(em, name, labels, value, _type_for(key))
        else:
            for k, v in value.items():
                _walk(em, name, str(k), v)
    elif isinstance(value, list):
        for item in value:
            if isinstance(item, dict) and "url" in item:
                url = str(item["url"])
                for k, v in item.items():
                    if isinstance(v, bool):
                        em.add(_name(name, k), {"url": url}, int(v), "gauge")
                    elif isinstance(v, (int, float)):
                        em.add(_name(name, k), {"url": url}, v, _type_for(k))
    # None and anything else: skipped


def _walk_labeled(em, name, label_names, value, mtype, bound=()) -> None:
    for k, v in value.items():
        pairs = bound + (str(k),)
        if isinstance(v, dict) and len(pairs) < len(label_names):
            _walk_labeled(em, name, label_names, v, mtype, pairs)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            em.add(name, dict(zip(label_names, pairs)), v, mtype)


def _render_histogram(em: _Emitter, name: str, hist: dict) -> None:
    """{buckets: [[le_ms, cumulative_count], ...], sum, count,
    exemplars: {le: {trace_id, value, ts}}} -> text exposition."""
    exemplars = hist.get("exemplars") or {}
    for le, count in hist.get("buckets", []):
        le_s = "+Inf" if le is None or math.isinf(le) else f"{float(le):g}"
        ex = exemplars.get(le_s)
        suffix = ""
        if ex:
            suffix = (
                f' # {{trace_id="{ex["trace_id"]}"}} '
                f'{_fmt(float(ex["value"]))} {_fmt(float(ex["ts"]))}'
            )
        em.add(f"{name}_bucket", {"le": le_s}, count, "histogram", suffix)
    em.add(f"{name}_sum", {}, hist.get("sum", 0.0), "histogram")
    em.add(f"{name}_count", {}, hist.get("count", 0), "histogram")


def render(snapshot: dict, prefix: str = PREFIX) -> str:
    """The whole JSON snapshot as Prometheus text exposition."""
    em = _Emitter()
    for key, value in snapshot.items():
        _walk(em, prefix, key, value)
    hist = snapshot.get("latency_ms_histogram")
    if isinstance(hist, dict):
        _render_histogram(em, _name(prefix, "latency_ms"), hist)
    dp = snapshot.get("dp_degraded")
    if isinstance(dp, dict):
        em.add(
            _name(prefix, "dp_degraded"),
            {"from": str(dp.get("from")), "to": str(dp.get("to"))},
            1,
            "gauge",
        )
    pools = snapshot.get("pools")
    if isinstance(pools, dict):
        for pool_name, psnap in pools.items():
            if not isinstance(psnap, dict):
                continue
            for k, v in psnap.items():
                if isinstance(v, bool):
                    em.add(_name(prefix, "pool", k), {"pool": pool_name},
                           int(v), "gauge")
                elif isinstance(v, (int, float)):
                    em.add(_name(prefix, "pool", k), {"pool": pool_name},
                           v, _type_for(k))
    return em.render()


def wants_prometheus(query_format: str | None, accept: str | None) -> bool:
    """Content negotiation: explicit `?format=prometheus` wins; otherwise a
    plain-text Accept (what Prometheus scrapers send) selects exposition
    and everything else (curl `*/*`, browsers) keeps the JSON view."""
    if query_format:
        return query_format.strip().lower() == "prometheus"
    return bool(accept) and "text/plain" in accept
