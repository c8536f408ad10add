# Copied from forge_tpu/runtime/space_harness.py (make_handler, run_space), with the --device flag.
"""The HTTP harness of a Forge Space app.

Every Space serves the two routes the SpaceManager drives
(runtime/spaces.py): GET returns the app's single page, POST /process runs
the app on a JSON body. An app is

    run_space("my space", PAGE, process,
              args=[("--ckpt", {"default": ...})], setup=load_models)

where `setup(args) → state` runs once before serving and `process(body,
state) → dict` answers each request. Any exception answers 500 with
{"error": …}. Every app takes `--host`, `--port` and `--device` (the
device its networks run on: absent, the CUDA card; "cpu" on request).
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


def make_handler(page_html: str, process: Callable[[dict, Any], dict], state: Any):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet: stdout is the readiness signal
            pass

        def _send(self, code, body, ctype="application/json"):
            data = body if isinstance(body, bytes) else body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            self._send(200, page_html, "text/html")

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length)) if length else {}
                self._send(200, json.dumps(process(body, state)))
            except Exception as e:  # noqa: BLE001 — reported to the client
                self._send(500, json.dumps({"error": str(e)}))

    return Handler


def run_space(title: str, page_html: str, process: Callable[[dict, Any], dict],
              default_port: int = 7870,
              args: Optional[Sequence[Tuple[str, Dict[str, Any]]]] = None,
              setup: Optional[Callable[[argparse.Namespace], Any]] = None,
              argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=default_port)
    ap.add_argument("--device", default=None,
                    help="the device the networks run on (default: the CUDA card)")
    for flag, kwargs in args or ():
        ap.add_argument(flag, **kwargs)
    ns = ap.parse_args(argv)
    state = setup(ns) if setup is not None else ns
    srv = ThreadingHTTPServer((ns.host, ns.port), make_handler(page_html, process, state))
    print(f"{title} on http://{ns.host}:{ns.port}", flush=True)
    srv.serve_forever()
