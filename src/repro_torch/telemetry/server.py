"""``TelemetryServer`` — stdlib HTTP/SSE endpoint over a
:class:`~repro_torch.telemetry.recorder.PowerRecorder`.

Zero dependencies: ``http.server.ThreadingHTTPServer`` (one daemon
thread per connection) bound to an ephemeral port by default
(``port=0`` — read the real one back from :attr:`port`), fully
exercisable with ``urllib`` in tests.

Endpoints (all JSON unless noted):

  * ``GET /``          — endpoint index.
  * ``GET /timeline``  — per-backend power series
    ``{"series": {backend: [[t, watts], ...]}, "window_mean_watts": x}``.
    Query: ``backend=<name>``, ``since=<t>`` (sensor-clock seconds),
    ``window=<s>`` (smoothing window for the mean, default 1.0).
  * ``GET /requests``  — per-request energy with the prefill/decode
    split; each request carries its contributing ``RegionRecord``\\ s as
    ``as_json()`` strings (bit-faithful round-trip).  Query:
    ``tenant=<name>`` filters to one tenant's requests.
  * ``GET /stats``     — recorder counters merged with engine-provided
    counters (``stall_events``/``stall_p95``, compile counts, throttle
    decisions — whatever the attached stats providers contribute).
  * ``GET /health``    — measurement-plane health: per-backend
    sampler/supervisor state (ok/degraded/failed), coverage gaps,
    staleness, and recent health transitions.
  * ``GET /stream``    — ``text/event-stream`` (SSE): a ``hello`` event,
    then one ``record`` event per newly resolved region record, one
    ``health`` event per backend health transition, and one ``preempt``
    event per serve-engine preemption-plane event (preempt / resume /
    quarantine / hung step / drain), with ``: keepalive`` comments
    while idle.  ``curl -N <url>/stream``.

Malformed query values (non-numeric/non-finite ``window=``/``since=``,
ill-formed ``tenant=``) return HTTP 400 with a JSON error body; an
unexpected handler error returns HTTP 500 with a JSON error body — a
monitoring client never sees a bare HTML traceback.

The serving thread never touches the measurement plane: every read
goes through the recorder's locked snapshots, and the SSE fan-out is a
bounded drop-oldest queue per client (see :mod:`repro_torch.telemetry.sse`).
"""
from __future__ import annotations

import http.server
import json
import math
import re
import threading
import urllib.parse
from typing import Optional

from repro_torch.telemetry.recorder import (HealthEvent, PowerRecorder,
                                            PreemptEvent)
from repro_torch.telemetry.sse import SSESubscriber, format_sse

_INDEX = {
    "endpoints": {
        "/timeline": "power series per backend "
                     "(?backend=, ?since=, ?window=)",
        "/requests": "per-request prefill/decode joules + raw records "
                     "(?tenant=)",
        "/stats": "engine + recorder counters (incl. preemption plane)",
        "/health": "per-backend sampler/supervisor health + transitions",
        "/stream": "SSE stream of resolved records + health + preempt "
                   "events (curl -N)",
    },
}

# Tenant names accepted on the query string: word chars, dot, dash.
_TENANT_RE = re.compile(r"^[\w.\-]{1,64}$")


class _BadQuery(ValueError):
    """A malformed query parameter (maps to HTTP 400)."""


def _parse_float(q, key, default=None, positive=False):
    """Parse a finite float query parameter or raise :class:`_BadQuery`."""
    if key not in q:
        return default
    raw = q[key]
    try:
        v = float(raw)
    except (TypeError, ValueError):
        raise _BadQuery(f"{key}={raw!r} is not a number")
    if not math.isfinite(v):
        raise _BadQuery(f"{key}={raw!r} must be finite")
    if positive and v <= 0:
        raise _BadQuery(f"{key}={raw!r} must be > 0")
    return v


class _Handler(http.server.BaseHTTPRequestHandler):
    # the server instance injects .recorder/.closing (see TelemetryServer)
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet: telemetry, not access logs
        pass

    # -- plumbing -----------------------------------------------------------
    def _send_json(self, payload, status: int = 200) -> None:
        body = json.dumps(payload, sort_keys=True).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _query(self):
        parsed = urllib.parse.urlsplit(self.path)
        return parsed.path, dict(urllib.parse.parse_qsl(parsed.query))

    # -- routes -------------------------------------------------------------
    def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
        path, q = self._query()
        try:
            if path == "/":
                self._send_json(_INDEX)
            elif path == "/timeline":
                self._timeline(q)
            elif path == "/requests":
                self._requests(q)
            elif path == "/stats":
                self._send_json(self.server.recorder.stats())
            elif path == "/health":
                self._send_json(self.server.recorder.health())
            elif path == "/stream":
                self._stream()
            else:
                self._send_json({"error": f"unknown path {path!r}"},
                                status=404)
        except (BrokenPipeError, ConnectionResetError):
            pass                      # client went away mid-response
        except _BadQuery as e:
            try:
                self._send_json({"error": str(e)}, status=400)
            except (BrokenPipeError, ConnectionResetError):
                pass
        except Exception as e:        # noqa: BLE001 — JSON 500, not a
            try:                      # bare HTML traceback page
                self._send_json(
                    {"error": f"internal error: {type(e).__name__}: {e}"},
                    status=500)
            except (BrokenPipeError, ConnectionResetError):
                pass

    def _timeline(self, q) -> None:
        rec: PowerRecorder = self.server.recorder
        since = _parse_float(q, "since")
        window = _parse_float(q, "window", default=1.0, positive=True)
        backend = q.get("backend")
        self._send_json({
            "series": rec.watts_series(backend=backend, since=since),
            "window_s": window,
            "window_mean_watts": rec.mean_watts(window, backend=backend),
        })

    def _requests(self, q) -> None:
        rec: PowerRecorder = self.server.recorder
        tenant = q.get("tenant")
        if tenant is not None and not _TENANT_RE.match(tenant):
            raise _BadQuery(f"tenant={tenant!r} is not a valid tenant "
                            "name ([\\w.-], 1-64 chars)")
        reqs = {str(rid): d
                for rid, d in rec.request_energy(tenant=tenant).items()}
        self._send_json({"requests": reqs, "count": len(reqs),
                         "tenant": tenant})

    def _stream(self) -> None:
        rec: PowerRecorder = self.server.recorder
        sub = SSESubscriber()
        unsubscribe = rec.subscribe(lambda r: sub.put(r))
        unsubscribe_health = rec.subscribe_health(lambda ev: sub.put(ev))
        unsubscribe_preempt = rec.subscribe_preempt(
            lambda ev: sub.put(ev))
        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            # SSE is an unbounded stream: no Content-Length, close
            # delimits (keep-alive would have the client wait forever).
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(format_sse(
                json.dumps({"records": rec.stats()["records"]}),
                event="hello"))
            self.wfile.flush()
            while not self.server.closing.is_set():
                item = sub.get(timeout=self.server.sse_keepalive_s)
                if item is None:
                    self.wfile.write(b": keepalive\n\n")
                else:
                    if isinstance(item, HealthEvent):
                        event = "health"
                    elif isinstance(item, PreemptEvent):
                        event = "preempt"
                    else:
                        event = "record"
                    self.wfile.write(format_sse(item.as_json(),
                                                event=event))
                self.wfile.flush()
        finally:
            unsubscribe()
            unsubscribe_health()
            unsubscribe_preempt()


class TelemetryServer:
    """Threaded HTTP/SSE server over a recorder.

    Args:
      recorder: the :class:`PowerRecorder` to serve.
      host: bind address (default loopback — telemetry is unauthenticated,
        so exposing it beyond the host is an explicit opt-in).
      port: TCP port; 0 (default) binds an ephemeral port, read it back
        from :attr:`port` after construction.

    ``start()`` returns immediately (daemon serving thread);
    ``close()`` shuts the listener down and releases SSE clients within
    one keep-alive period.  Usable as a context manager.
    """

    def __init__(self, recorder: PowerRecorder, host: str = "127.0.0.1",
                 port: int = 0, sse_keepalive_s: float = 0.25):
        self.recorder = recorder
        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      _Handler)
        self._httpd.daemon_threads = True
        self._httpd.recorder = recorder
        self._httpd.closing = threading.Event()
        self._httpd.sse_keepalive_s = float(sse_keepalive_s)
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self.url = f"http://{host}:{self.port}"
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TelemetryServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.05},
                name="pmt-telemetry-http", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        """Stop serving (idempotent): unblocks SSE handlers, shuts the
        accept loop down, and closes the listening socket."""
        self._httpd.closing.set()
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd.server_close()

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
