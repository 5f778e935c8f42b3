"""Profiling of the port (counterpart of spotter_tpu.engine.profiler).

- `capture(log_dir, duration_s)`: a timed `torch.profiler` capture of the
  host and the card (CPU and CUDA activities), written as a Chrome trace
  into `log_dir`: the device work of whatever traffic is in flight lands
  in it. One capture at a time, and 0 < duration_s <= 60, with the JAX
  package's checks and texts. The `/profile` endpoint that calls it comes
  with the replica's obs plane (ROADMAP Queue 1 item 6).
- `refuse_profiler_port()`: the JAX package starts jax.profiler's
  gRPC server when `SPOTTER_TPU_PROFILER_PORT` is set. torch has no such
  server, so the knob raises at bring-up instead of being ignored.

The per-stage latency breakdown (decode / h2d / device / postprocess) is in
`Metrics.record_batch(..., stages=...)`: always on, host-side only.
"""

import os
import threading
import time

PROFILER_PORT_ENV = "SPOTTER_TPU_PROFILER_PORT"
TRACE_FILE = "trace.json"


def refuse_profiler_port() -> None:
    """Raise when SPOTTER_TPU_PROFILER_PORT is set: the port has no live
    profiler server to start on it."""
    port = os.environ.get(PROFILER_PORT_ENV, "")
    if port:
        raise ValueError(
            f"{PROFILER_PORT_ENV}={port!r}: torch has no gRPC profiler server; live "
            f"profiling is not ported (ROADMAP Queue 1 item 6), use profiler.capture; "
            f"unset it to serve without it"
        )


_capture_lock = threading.Lock()


def capture(log_dir: str, duration_s: float = 1.0) -> dict:
    """Timed capture: trace everything the host and the card run for
    `duration_s`, into `log_dir`/trace.json (Chrome trace format).

    Serializes captures (one torch.profiler session at a time); returns a
    small summary for the caller to serve."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    duration_s = float(duration_s)
    if not (0.0 < duration_s <= 60.0):  # also rejects NaN
        raise ValueError(f"duration_s must be in (0, 60], got {duration_s}")
    if not _capture_lock.acquire(blocking=False):
        raise RuntimeError("a profiler capture is already running")
    try:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        t0 = time.monotonic()
        # the context manager stops the session on any exit, so no orphaned
        # trace blocks a later capture
        with profile(activities=activities) as prof:
            time.sleep(duration_s)
        path = os.path.join(log_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        return {
            "log_dir": log_dir,
            "trace": path,
            "duration_s": round(time.monotonic() - t0, 3),
            "activities": [a.name for a in activities],
        }
    finally:
        _capture_lock.release()
