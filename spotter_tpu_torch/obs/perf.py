"""Device-efficiency ledger of the port (its own copy of
spotter_tpu.obs.perf): MFU accounting, the capture ledger, memory gauges
and SLO burn-rate. Stdlib only at import.

- **PerfLedger**: per-dispatch device time, FLOPs, and padded/valid
  pixels, windowed into `mfu_pct` (dispatched FLOPs over the window vs
  peak), `useful_mfu_pct` (valid-pixel-weighted: MFU net of padding) and
  `device_duty_cycle_pct` (device-busy share of wall time). FLOPs per
  shape key come from the engine's one eager forward under
  `torch.utils.flop_counter.FlopCounterMode`, folded with what the
  hand-written kernels' wrappers note (`note_kernel_flops`: the counter
  cannot see a ctypes launch); peak TFLOP/s from
  `SPOTTER_TPU_PEAK_TFLOPS`, else by the card's name. Keeps a top-K
  most-expensive-dispatch table.
- **CompileLedger**: every CUDA-graph capture (the port's counterpart of
  a compiled program; sources `warmup`, `traffic`, `oom_downgrade`,
  `rebuild`) with shape key, wall time and provenance; a replay counts as
  a program-cache hit, with a storm warning when captures cluster.
- **HbmSampler**: a daemon thread polling `torch.cuda.memory_stats` and
  `torch.cuda.mem_get_info` into per-device `hbm_bytes_in_use` /
  `hbm_peak_bytes` / `hbm_limit_bytes` gauges (a CPU device gives None:
  its row stays at zero, never NaN).
- **SloBurn**: fast/slow-window (1 m / 30 m) error-budget burn over
  deadline misses + sheds vs `SPOTTER_TPU_SLO_TARGET_PCT`.

Every rate and percentage is NaN-free: an idle replica reports 0.0, and
`SPOTTER_TPU_PERF_LEDGER=0` turns every record call into a no-op.
"""

import logging
import math
import os
import threading
import time
from collections import deque

logger = logging.getLogger(__name__)

PERF_LEDGER_ENV = "SPOTTER_TPU_PERF_LEDGER"
PEAK_TFLOPS_ENV = "SPOTTER_TPU_PEAK_TFLOPS"
PERF_WINDOW_ENV = "SPOTTER_TPU_PERF_WINDOW_S"
PERF_TOP_K_ENV = "SPOTTER_TPU_PERF_TOP_K"
SLO_TARGET_PCT_ENV = "SPOTTER_TPU_SLO_TARGET_PCT"
HBM_SAMPLE_ENV = "SPOTTER_TPU_HBM_SAMPLE_S"
COMPILE_STORM_ENV = "SPOTTER_TPU_COMPILE_STORM"

DEFAULT_PERF_WINDOW_S = 60.0
DEFAULT_PERF_TOP_K = 16
DEFAULT_SLO_TARGET_PCT = 99.0
DEFAULT_HBM_SAMPLE_S = 1.0
# compiles inside one perf window before the storm warning fires — warmup
# legitimately compiles the whole bucket ladder, so the bar sits above it
DEFAULT_COMPILE_STORM = 8

# fast/slow burn-rate windows (seconds): the multiwindow alerting shape —
# fast catches an active incident, slow confirms sustained budget spend
FAST_WINDOW_S = 60.0
SLOW_WINDOW_S = 1800.0

# Peak dense bf16 TFLOP/s per device by name substring (first match wins;
# sources: public spec sheets). The H100 entry is its SXM sheet's dense
# bf16 figure, the one chip_smoke.py's bounds use; the CPU entry is a rough
# host figure so CPU runs give a finite, nonzero MFU instead of None.
_PEAK_TFLOPS_BY_KIND = (
    ("h100", 989.0),
    ("cpu", 0.2),
)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def perf_enabled() -> bool:
    return os.environ.get(PERF_LEDGER_ENV, "1").strip() not in ("", "0")


def peak_tflops_for(device_kind: str | None) -> float | None:
    """Per-chip peak TFLOPs: the env override wins, then the kind table.

    Unknown kinds return None: MFU then reports 0.0 rather than a number
    computed against a made-up peak.
    """
    raw = os.environ.get(PEAK_TFLOPS_ENV, "").strip()
    if raw:
        try:
            v = float(raw)
            if v > 0 and math.isfinite(v):
                return v
        except ValueError:
            pass
    if not device_kind:
        return None
    kind = device_kind.lower()
    for marker, tflops in _PEAK_TFLOPS_BY_KIND:
        if marker in kind:
            return tflops
    return None


# --- per-kernel FLOP notes for the hand-written kernels ------------------
#
# `FlopCounterMode` counts the aten ops a forward dispatches; a kernel
# launched through ctypes never reaches it, so a forward whose work lives in
# the MSDA, attention, class-logit or int8 kernels would report too few
# FLOPs and a fictitious mfu_pct. Each kernel's wrapper therefore *notes*
# its analytic FLOPs (the JAX package's formula for its Pallas counterpart;
# the standard count where XLA counted the JAX side's dot) through
# `note_kernel_flops`; the merged MSDA kernels' formula needs the value's
# levels, so the MSDA op that calls them notes for them. The engine wraps
# its counting forward in `collect_kernel_flops()` and folds the total in
# (`combine_flops`).

_KERNEL_FLOPS_LOCK = threading.Lock()
_KERNEL_FLOPS_COLLECTORS: list[dict] = []


def note_kernel_flops(name: str, flops) -> None:
    """Record `flops` for one hand-written kernel call into every active
    collector. Called by the kernel's wrapper on every call, on the card and
    on the CPU alike; a no-op when nothing is collecting, so steady-state
    dispatch paths pay one lock acquire and a list check."""
    try:
        f = float(flops)
    except (TypeError, ValueError):
        return
    if not math.isfinite(f) or f <= 0:
        return
    with _KERNEL_FLOPS_LOCK:
        for c in _KERNEL_FLOPS_COLLECTORS:
            c[name] = c.get(name, 0.0) + f
            c["__total__"] = c.get("__total__", 0.0) + f


class collect_kernel_flops:
    """Context manager: collect `note_kernel_flops` totals emitted while
    the block runs. Yields a dict of kernel name -> accumulated FLOPs plus
    a `__total__` key. Re-entrant and thread-safe (concurrent collectors
    each see every note; the engine counts one forward per collector)."""

    def __enter__(self):
        self._c: dict = {}
        with _KERNEL_FLOPS_LOCK:
            _KERNEL_FLOPS_COLLECTORS.append(self._c)
        return self._c

    def __exit__(self, *exc):
        with _KERNEL_FLOPS_LOCK:
            try:
                _KERNEL_FLOPS_COLLECTORS.remove(self._c)
            except ValueError:
                pass
        return False


def combine_flops(ca_flops, kernel_flops) -> float | None:
    """Fold the counted FLOPs (`FlopCounterMode`'s total) with the noted
    kernel FLOPs, by the JAX package's rule.

    - counted missing/zero: the noted total stands alone (None when both
      are empty: the caller's cache records an honest failure).
    - counted present but BELOW the noted total: the counter did not see
      the kernels (a forward containing a kernel cannot cost less than the
      kernel): add the noted total on top.
    - counted >= noted total: trust it (on the CPU a wrapper runs its plain
      version, whose products the counter does see; adding would
      double-count).
    """
    ca = None
    try:
        ca = float(ca_flops) if ca_flops else None
    except (TypeError, ValueError):
        ca = None
    if ca is not None and (not math.isfinite(ca) or ca <= 0):
        ca = None
    kf = float(kernel_flops or 0.0)
    if not math.isfinite(kf) or kf <= 0:
        kf = 0.0
    if ca is None:
        return kf if kf > 0 else None
    if kf > 0 and ca < kf:
        return ca + kf
    return ca


class SloBurn:
    """Error-budget burn over per-second good/bad counters.

    `bad` events are deadline misses + sheds (the two ways a request the
    SLO counts fails without the engine itself erroring); `good` events
    are completed images. burn = error_ratio / error_budget per window:
    1.0 means the budget drains exactly at the sustainable rate.
    """

    def __init__(self, target_pct: float | None = None) -> None:
        if target_pct is None:
            target_pct = _env_float(SLO_TARGET_PCT_ENV, DEFAULT_SLO_TARGET_PCT)
        # clamp: a 100% target has zero budget and every error would be an
        # infinite burn — floor the budget so the gauge stays finite
        self.target_pct = min(max(float(target_pct), 0.0), 100.0)
        self.budget = max(1.0 - self.target_pct / 100.0, 1e-4)
        self._lock = threading.Lock()
        # second -> [good, bad]; pruned past the slow window
        self._buckets: dict[int, list[int]] = {}

    def _bucket(self, now: float) -> list[int]:
        sec = int(now)
        b = self._buckets.get(sec)
        if b is None:
            b = self._buckets[sec] = [0, 0]
            # prune on insert (bounded: one entry per second per window)
            horizon = sec - int(SLOW_WINDOW_S) - 1
            for k in [k for k in self._buckets if k < horizon]:
                del self._buckets[k]
        return b

    def good(self, n: int = 1) -> None:
        with self._lock:
            self._bucket(time.monotonic())[0] += n

    def bad(self, n: int = 1) -> None:
        with self._lock:
            self._bucket(time.monotonic())[1] += n

    def _window_counts(self, window_s: float, now: float) -> tuple[int, int]:
        lo = int(now - window_s)
        good = bad = 0
        for sec, (g, b) in self._buckets.items():
            if sec >= lo:
                good += g
                bad += b
        return good, bad

    def burn(self, window_s: float) -> float:
        """Burn rate over the window; 0.0 with zero traffic (never NaN)."""
        with self._lock:
            good, bad = self._window_counts(window_s, time.monotonic())
        total = good + bad
        if total <= 0:
            return 0.0
        return (bad / total) / self.budget

    def rates(self) -> dict:
        """{"fast": x, "slow": y} — the /metrics gauge pair."""
        return {
            "fast": round(self.burn(FAST_WINDOW_S), 4),
            "slow": round(self.burn(SLOW_WINDOW_S), 4),
        }

    def export(self) -> dict:
        """Raw good/bad second-buckets as [age_s, good, bad] triples:
        ages instead of absolute seconds because monotonic
        clocks don't compare across processes. The fleet aggregator sums
        these across replicas and recomputes burn from the merged counts —
        a fleet burn rate is never an average of member burn rates."""
        with self._lock:
            sec_now = int(time.monotonic())
            buckets = [
                [sec_now - sec, g, b]
                for sec, (g, b) in sorted(self._buckets.items())
                if 0 <= sec_now - sec <= int(SLOW_WINDOW_S)
            ]
        return {"target_pct": self.target_pct, "buckets": buckets}

    def block(self) -> dict:
        """The /healthz `slo_burn` block: windows, counts, and burn."""
        with self._lock:
            now = time.monotonic()
            fast = self._window_counts(FAST_WINDOW_S, now)
            slow = self._window_counts(SLOW_WINDOW_S, now)

        def one(window_s: float, counts: tuple[int, int]) -> dict:
            good, bad = counts
            total = good + bad
            ratio = bad / total if total else 0.0
            return {
                "window_s": window_s,
                "good": good,
                "bad": bad,
                "error_ratio": round(ratio, 6),
                "burn_rate": round(ratio / self.budget, 4),
            }

        return {
            "target_pct": self.target_pct,
            "fast": one(FAST_WINDOW_S, fast),
            "slow": one(SLOW_WINDOW_S, slow),
        }


class CompileLedger:
    """Every captured CUDA graph (the port's compiled program), with shape
    key, wall time, and provenance.

    `record_dispatch(shape)` is the cache-hit check the engine calls per
    dispatch: False (seen before) counts a program-cache hit, True means
    the caller is about to pay a compile and should time it into
    `record_compile`. Sources: warmup, traffic (first live shape — under
    ragged batching, a canvas snap), oom_downgrade, rebuild.
    """

    def __init__(self, storm_threshold: int | None = None) -> None:
        if storm_threshold is None:
            storm_threshold = _env_int(COMPILE_STORM_ENV, DEFAULT_COMPILE_STORM)
        self.storm_threshold = max(1, storm_threshold)
        self._lock = threading.Lock()
        self._shapes: dict[str, dict] = {}
        self.compiles_total = 0
        self.compile_seconds_total = 0.0
        self.cache_hits_total = 0
        self._recent: deque[float] = deque(maxlen=256)
        self._last_storm_warn = 0.0

    def record_dispatch(self, shape: str) -> bool:
        """True when `shape` has never compiled here (caller must follow
        with record_compile); False counts a program-cache hit."""
        with self._lock:
            if shape in self._shapes:
                self.cache_hits_total += 1
                return False
            # reserve the slot so a concurrent dispatch of the same novel
            # shape doesn't double-record the compile
            self._shapes[shape] = {
                "shape": shape, "source": "pending", "wall_s": 0.0, "count": 0,
            }
            return True

    def record_compile(self, shape: str, wall_s: float, source: str) -> None:
        now = time.monotonic()
        with self._lock:
            entry = self._shapes.setdefault(
                shape,
                {"shape": shape, "source": source, "wall_s": 0.0, "count": 0},
            )
            entry["source"] = source
            entry["wall_s"] = round(entry["wall_s"] + max(wall_s, 0.0), 4)
            entry["count"] += 1
            self.compiles_total += 1
            self.compile_seconds_total += max(wall_s, 0.0)
            self._recent.append(now)
            recent = sum(1 for t in self._recent if now - t <= FAST_WINDOW_S)
            storm = (
                recent > self.storm_threshold
                and now - self._last_storm_warn > FAST_WINDOW_S
            )
            if storm:
                self._last_storm_warn = now
        if storm:
            # outside the lock: a recompile storm means the shape set is
            # not bounded (ragged snap grid misconfigured, bucket churn) —
            # every compile stalls serving for its wall time
            logger.warning(
                "recompile storm: %d program compiles in the last %.0f s "
                "(threshold %d) — latest shape %s; check the ragged snap "
                "step / bucket ladder for unbounded shape churn",
                recent, FAST_WINDOW_S, self.storm_threshold, shape,
            )

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "compiles_total": self.compiles_total,
                "compile_seconds_total": round(self.compile_seconds_total, 4),
                "program_cache_hits_total": self.cache_hits_total,
                "compile_shapes": [
                    dict(e) for e in self._shapes.values() if e["count"] > 0
                ],
            }


class PerfLedger:
    """Windowed device-efficiency accounting over per-dispatch records."""

    def __init__(
        self,
        window_s: float | None = None,
        enabled: bool | None = None,
        top_k: int | None = None,
    ) -> None:
        self.enabled = perf_enabled() if enabled is None else enabled
        self.window_s = (
            _env_float(PERF_WINDOW_ENV, DEFAULT_PERF_WINDOW_S)
            if window_s is None
            else window_s
        )
        self.top_k = (
            _env_int(PERF_TOP_K_ENV, DEFAULT_PERF_TOP_K)
            if top_k is None
            else top_k
        )
        self._lock = threading.Lock()
        self._created = time.monotonic()
        # (t_end_mono, device_s, flops, useful_flops) for the windowed math
        self._dispatches: deque[tuple[float, float, float, float]] = deque(
            maxlen=4096
        )
        # most-expensive dispatches (by device time), kept sorted desc —
        # the /debug/perf join into the flight recorder
        self._top: list[dict] = []
        self.device_kind: str | None = None
        self.n_devices = 1
        self.peak_tflops: float | None = None
        self._flops_cache: dict[str, float | None] = {}
        self.compiles = CompileLedger()
        self.slo = SloBurn()
        self._hbm: dict[str, dict] = {}

    # -- configuration ----------------------------------------------------

    def set_device_info(self, device_kind: str | None, n_devices: int) -> None:
        with self._lock:
            self.device_kind = device_kind
            self.n_devices = max(1, int(n_devices))
            self.peak_tflops = peak_tflops_for(device_kind)

    def flops_for(self, shape: str, compute=None) -> float | None:
        """Cached FLOPs per shape key. `compute` (a callable returning
        float|None, the engine's counted eager forward)
        runs at most once per shape; failures cache as None so a broken
        cost-analysis path costs one attempt, not one per dispatch."""
        with self._lock:
            if shape in self._flops_cache:
                return self._flops_cache[shape]
        if compute is None:
            return None
        try:
            flops = compute()
            if flops is not None:
                flops = float(flops)
                if not math.isfinite(flops) or flops <= 0.0:
                    flops = None
        except Exception:
            logger.debug("cost analysis failed for %s", shape, exc_info=True)
            flops = None
        with self._lock:
            self._flops_cache[shape] = flops
        return flops

    # -- recording --------------------------------------------------------

    def record_dispatch(
        self,
        device_s: float,
        batch: int,
        padded_px: int | None = None,
        valid_px: int | None = None,
        flops: float | None = None,
        trace_id: str | None = None,
        shape: str | None = None,
    ) -> None:
        """One engine dispatch: its device window, the FLOPs the compiled
        program spends (padding included — that is the point), and the
        valid/padded pixel split that discounts `useful_mfu_pct`."""
        if not self.enabled:
            return
        device_s = max(float(device_s), 0.0)
        f = float(flops) if flops else 0.0
        if padded_px and valid_px is not None and padded_px > 0:
            useful = f * min(max(valid_px / padded_px, 0.0), 1.0)
        else:
            useful = f
        now = time.monotonic()
        with self._lock:
            self._dispatches.append((now, device_s, f, useful))
            if self.top_k > 0:
                device_ms = device_s * 1e3
                if (
                    len(self._top) < self.top_k
                    or device_ms > self._top[-1]["device_ms"]
                ):
                    self._top.append({
                        "device_ms": round(device_ms, 3),
                        "batch": int(batch),
                        "shape": shape,
                        "flops": f or None,
                        "padded_px": padded_px,
                        "valid_px": valid_px,
                        "trace_id": trace_id,
                        "ts": time.time(),
                    })
                    self._top.sort(key=lambda e: e["device_ms"], reverse=True)
                    del self._top[self.top_k:]

    def set_hbm(self, device: str, stats: dict | None) -> None:
        """One device's `device_memory_stats` poll (None-safe: a CPU device
        gives None, and the gauges stay at their last/zero values)."""
        if stats is None:
            return
        with self._lock:
            self._hbm[str(device)] = {
                "bytes_in_use": int(stats.get("bytes_in_use", 0) or 0),
                "peak_bytes": int(stats.get("peak_bytes_in_use", 0) or 0),
                "limit_bytes": int(stats.get("bytes_limit", 0) or 0),
            }

    def ensure_hbm_device(self, device: str) -> None:
        """Guarantee a `hbm_per_device` row for `device` WITHOUT overwriting
        a last-known reading: a device whose statistics are unavailable
        (CPU backends, a transient poll failure) still shows up — zeroed —
        so a dp×tp mesh's full device set is auditable in /metrics even on
        on a CPU device."""
        with self._lock:
            self._hbm.setdefault(
                str(device),
                {"bytes_in_use": 0, "peak_bytes": 0, "limit_bytes": 0},
            )

    # -- views ------------------------------------------------------------

    def _window_sums(self, now: float) -> tuple[float, float, float, float]:
        """(span_s, device_s, flops, useful_flops) over the trailing window."""
        span = min(self.window_s, max(now - self._created, 1e-9))
        lo = now - span
        dev = fl = uf = 0.0
        for t_end, device_s, flops, useful in self._dispatches:
            if t_end >= lo:
                dev += device_s
                fl += flops
                uf += useful
        return span, dev, fl, uf

    def snapshot(self) -> dict:
        """The /metrics view: every gauge present and NaN-free, idle or not."""
        with self._lock:
            now = time.monotonic()
            span, dev_s, flops, useful = self._window_sums(now)
            peak_flops = (
                self.peak_tflops * 1e12 * self.n_devices
                if self.peak_tflops
                else None
            )
            mfu = 100.0 * flops / (span * peak_flops) if peak_flops else 0.0
            useful_mfu = (
                100.0 * useful / (span * peak_flops) if peak_flops else 0.0
            )
            duty = min(100.0 * dev_s / span, 100.0)
            hbm = {k: dict(v) for k, v in self._hbm.items()}
        out = {
            "mfu_pct": round(mfu, 3),
            "useful_mfu_pct": round(useful_mfu, 3),
            "device_duty_cycle_pct": round(duty, 3),
            "perf_window_s": self.window_s,
            "peak_tflops": self.peak_tflops,
            "device_kind": self.device_kind,
            "devices": self.n_devices,
            "hbm_bytes_in_use": sum(v["bytes_in_use"] for v in hbm.values()),
            "hbm_peak_bytes": sum(v["peak_bytes"] for v in hbm.values()),
            "hbm_limit_bytes": sum(v["limit_bytes"] for v in hbm.values()),
            "hbm_per_device": hbm,
            "slo_target_pct": self.slo.target_pct,
            "slo_burn_rate": self.slo.rates(),
            # mergeable raw state: the window sums behind
            # mfu/duty so fleet MFU recomputes as sum(flops)/sum(span*peak)
            # across replicas — never an average of member percentages
            "perf_raw": {
                "window_span_s": round(span, 3),
                "device_s": round(dev_s, 6),
                "flops": flops,
                "useful_flops": useful,
                "peak_flops": peak_flops or 0.0,
            },
        }
        # outside self._lock: SloBurn owns its own lock
        out["slo_burn_raw"] = self.slo.export()
        out.update(self.compiles.snapshot())
        return out

    def top_dispatches(self, k: int | None = None) -> list[dict]:
        with self._lock:
            top = [dict(e) for e in self._top]
        return top[: k if k is not None else self.top_k]

    def debug_snapshot(self, k: int | None = None) -> dict:
        """The /debug/perf payload: the efficiency gauges plus the tables
        too wide for /metrics: top-K dispatches, the full capture table,
        per-device HBM, and the burn-rate detail block."""
        return {
            **self.snapshot(),
            "top_dispatches": self.top_dispatches(k),
            "slo_burn": self.slo.block(),
        }


class HbmSampler:
    """Daemon thread polling each device's allocator into a PerfLedger.

    `devices_fn` re-resolves the device list each tick. A CPU device has
    no allocator statistics (`device_memory_stats` gives None): its row
    stays at zero.
    """

    def __init__(
        self,
        devices_fn,
        ledger: PerfLedger,
        interval_s: float | None = None,
    ) -> None:
        if interval_s is None:
            interval_s = _env_float(HBM_SAMPLE_ENV, DEFAULT_HBM_SAMPLE_S)
        self.interval_s = interval_s
        self._devices_fn = devices_fn
        self._ledger = ledger
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def sample_once(self) -> None:
        sample_hbm_once(self._devices_fn, self._ledger)

    def start(self) -> bool:
        """Start polling; False when disabled (interval <= 0)."""
        if self.interval_s <= 0 or self._thread is not None:
            return False
        self._thread = threading.Thread(
            target=self._run, name="spotter-hbm-sampler", daemon=True
        )
        self._thread.start()
        return True

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.sample_once()
            except Exception:
                logger.debug("hbm sample failed", exc_info=True)
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def device_memory_stats(device) -> dict | None:
    """A torch device's allocator gauges in the ledger's keys, or None for a
    device without them (the CPU): `bytes_in_use` and `peak_bytes_in_use`
    from `torch.cuda.memory_stats` (bytes held by live tensors, current and
    peak), `bytes_limit` from `torch.cuda.mem_get_info` (the card's total)."""
    import torch  # the ledger itself stays importable without torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
    }


def sample_hbm_once(devices_fn, ledger: PerfLedger) -> int:
    """Poll every device once; returns how many reported stats (0 on CPU)."""
    reported = 0
    try:
        devices = devices_fn() or []
    except Exception:
        return 0
    for i, d in enumerate(devices):
        key = str(getattr(d, "index", None) if getattr(d, "index", None) is not None else i)
        try:
            stats = device_memory_stats(d)
        except Exception:
            stats = None
        if stats:
            ledger.set_hbm(key, stats)
            reported += 1
        else:
            # presence without a reading: every polled device keeps a row
            # (zeroed until it reports)
            ledger.ensure_hbm_device(key)
    return reported
