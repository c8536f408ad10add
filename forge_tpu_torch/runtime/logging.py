# Copied from forge_tpu/runtime/logging.py (configure, log_event with its size rotation); stdlib only.
"""Structured event logging: JSON-lines telemetry for serving deployments.

One line per event to `logs/events.jsonl` (relative to the working
directory unless `configure` names another path; past `max_bytes` the file
is renamed to `<path>.1` before the next line), and to stdout under `echo`:

  {"ts": ..., "event": "generation", "sampler": "...", "t_total": 1.2, ...}

Wired from the API (`api_request` for every answered `/sdapi` route,
`api_error` for a request that fails with a server error) and from
`process_images` (`generation`, with the request's sampler, size, batch,
seed and phase timings). Thread-safe; it never raises; `configure(enabled=
False)` turns it off.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Optional

_LOCK = threading.Lock()
_PATH: Optional[str] = None
_ECHO = False
_MAX_BYTES = 16 << 20
_ENABLED = True


def configure(path: str = "logs/events.jsonl", echo: bool = False,
              max_bytes: int = 16 << 20, enabled: bool = True):
    global _PATH, _ECHO, _MAX_BYTES, _ENABLED
    _PATH, _ECHO, _MAX_BYTES, _ENABLED = path, echo, max_bytes, enabled


def _default(o):
    try:
        return float(o)
    except Exception:
        return str(o)


def log_event(event: str, **fields: Any):
    """Append one JSON line; never raises (logging must not break serving)."""
    if not _ENABLED:
        return
    global _PATH
    rec = {"ts": round(time.time(), 3), "event": event, **fields}
    try:
        line = json.dumps(rec, default=_default)
    except Exception:
        return
    with _LOCK:
        if _PATH is None:
            _PATH = "logs/events.jsonl"
        try:
            os.makedirs(os.path.dirname(_PATH) or ".", exist_ok=True)
            if os.path.exists(_PATH) and os.path.getsize(_PATH) > _MAX_BYTES:
                os.replace(_PATH, _PATH + ".1")  # single-file rotation
            with open(_PATH, "a", encoding="utf-8") as f:
                f.write(line + "\n")
        except OSError:
            pass
        if _ECHO:
            print(line)
