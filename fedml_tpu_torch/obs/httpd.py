"""Stdlib HTTP introspection endpoint: poke a long run without a shell on
its machine (port of fedml_tpu/obs/httpd.py).

SIGUSR1 flight dumps (``flight.py``) need an operator who can signal the
process; a run in a container or on a remote host often cannot be
signalled.  One daemon ThreadingHTTPServer (no dependencies) serves:

    /metrics   Prometheus text exposition (the always-on registry)
    /rollup    obs.rollup() JSON: headline counters and artifact paths
    /healthz   200 + {status, pid, uptime_s}: the liveness probe
    /slo       the installed SLO engine's pack report (obs/slo.py); 503
               until one is installed (``SloEngine.start`` or
               ``slo.install``).  It carries ``scope: local|cluster``:
               "local" is one rank's view, and a dashboard must not read
               a worker's green as the cluster's
    /cluster   the cluster observatory (obs/cluster.py): per-rank
               liveness, epoch and last-fold age, the barrier straggler
               summary, the cluster SLO view, the top counters — a
               cluster-wide view only on the coordinator
               (scope == "cluster")
    /flight    POST: trigger a flight-recorder dump, return its path.
               GET: return the last dump's path without triggering one
               (a scraper or a browser's prefetch must never dump)

Enable it with ``FEDML_OBS_HTTP_PORT=<port>`` (read by
``obs.configure``) or ``obs.serve_http(port)``.  Port 0 binds an
ephemeral port, found on ``ObsHttpServer.port`` and in ``obs.rollup()``.
It binds 127.0.0.1 only: an operator's loopback hatch, not a service.
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class ObsHttpServer:
    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        from fedml_tpu_torch import obs
        from fedml_tpu_torch.obs import cluster as cluster_mod
        from fedml_tpu_torch.obs import slo as slo_mod
        started = time.monotonic()

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, doc) -> None:
                self._send(code, json.dumps(doc).encode(),
                           "application/json")

            def do_GET(self):                        # noqa: N802 (stdlib)
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/metrics":
                    self._send(200,
                               obs.registry().to_prometheus().encode(),
                               "text/plain; version=0.0.4")
                elif path == "/rollup":
                    self._json(200, obs.rollup())
                elif path == "/healthz":
                    self._json(200, {"status": "ok", "pid": os.getpid(),
                                     "uptime_s": round(
                                         time.monotonic() - started, 3)})
                elif path == "/slo":
                    eng = slo_mod.active()
                    if eng is None:
                        self._json(503, {"error": "no SLO engine "
                                                  "installed "
                                                  "(SloEngine.start)"})
                    else:
                        doc = eng.report()
                        # whose truth this is: "local" = this rank only;
                        # "cluster" = the coordinator's folded view
                        doc["scope"] = cluster_mod.scope()
                        self._json(200, doc)
                elif path == "/cluster":
                    self._json(200, cluster_mod.cluster_report())
                elif path == "/flight":
                    # read-only: report the last dump, never trigger one
                    f = obs.flight()
                    dumps = list(f.dumps) if f is not None else []
                    self._json(200, {"last_dump": (dumps[-1] if dumps
                                                   else None),
                                     "dumps": len(dumps),
                                     "trigger": "POST /flight"})
                else:
                    self._json(404, {"error": "unknown path"})

            def do_POST(self):                       # noqa: N802 (stdlib)
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/flight":
                    dump = obs.dump_flight("http_trigger")
                    body = {"dump": dump,
                            "error": (None if dump is not None
                                      else "obs not configured "
                                           "(no obs directory)")}
                    self._json(200 if dump is not None else 503, body)
                else:
                    # every other endpoint is a read: POST falls through
                    # to the same representation
                    self.do_GET()

            def log_message(self, *a):               # no stderr noise
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-http",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
