"""Tiny HTTP observability sidecar for the detection daemon.

The port of `cough_detector_tpu/serve/stats_http.py`. Production daemons
need a scrape surface (load balancers, supervisors, dashboards) that does
not ride the detection wire protocol. This serves:

    GET /healthz  -> 200 "ok" once the daemon is serving (warm tick done,
                     clients accepted), 503 before/after
    GET /stats    -> 200 application/json, one DetectionServer.stats()
                     snapshot (tick cadence, latency percentiles, event
                     and drop counters — see serve/server.py)

Standard library only (http.server on a daemon thread); GETs never
touch the tick path — stats() takes the stats lock for a dict copy,
which is the same cost the periodic CLI stats line already pays.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple


class StatsHttpServer:
    """Serve /healthz and /stats for one daemon.

    `get_stats` is called per request (a snapshot, never cached);
    `set_ready` gates /healthz so orchestrators can tell "starting" from
    "serving".
    """

    def __init__(
        self,
        get_stats: Callable[[], dict],
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self._ready = threading.Event()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path == "/healthz":
                    if outer._ready.is_set():
                        self._send(200, b"ok", "text/plain")
                    else:
                        self._send(503, b"starting", "text/plain")
                elif self.path == "/stats":
                    try:
                        body = json.dumps(get_stats()).encode()
                    except Exception as err:  # never take the scraper down
                        self._send(
                            500,
                            json.dumps({"error": repr(err)}).encode(),
                            "application/json",
                        )
                        return
                    self._send(200, body, "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:
                pass  # scrapes every few seconds — keep stdout clean

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    def set_ready(self, ready: bool = True) -> None:
        if ready:
            self._ready.set()
        else:
            self._ready.clear()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
