"""Structured JSON logs carrying the trace id (`SPOTTER_TPU_LOG_JSON=1`;
the port's own copy of spotter_tpu.obs.logs).

Every log record emitted while a request trace is active carries its
`trace_id` and `request_id`, so a grep for the X-Request-ID a client quoted
lands on the exact log lines and the /debug/traces entry of the same
request. Off by default: the env knob flips every root handler to JSON.
"""

import json
import logging
import os
import time

from spotter_tpu_torch.obs.trace import current_trace

LOG_JSON_ENV = "SPOTTER_TPU_LOG_JSON"


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": round(record.created, 6),
            "iso": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)
            ) + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        trace = current_trace()
        if trace is not None:
            entry["trace_id"] = trace.trace_id
            entry["request_id"] = trace.request_id
        if record.exc_info and record.exc_info[0] is not None:
            entry["exc"] = self.formatException(record.exc_info)
        return json.dumps(entry, default=str)


def json_logs_enabled() -> bool:
    return os.environ.get(LOG_JSON_ENV, "0").strip() not in ("", "0")


def maybe_setup_json_logging() -> bool:
    """Swap every root-logger handler to the JSON formatter when the env
    asks for it. Call after logging.basicConfig so there is a handler to
    re-format. Returns whether JSON mode is active."""
    if not json_logs_enabled():
        return False
    root = logging.getLogger()
    if not root.handlers:
        logging.basicConfig(level=logging.INFO)
    formatter = JsonFormatter()
    for handler in root.handlers:
        handler.setFormatter(formatter)
    return True
