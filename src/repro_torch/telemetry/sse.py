"""Server-Sent Events plumbing for the telemetry server.

SSE (``text/event-stream``) is the zero-dependency live-push channel:
one long-lived HTTP response the server appends ``event:``/``data:``
framed messages to, consumable with ``curl -N`` or a browser
``EventSource`` — no websocket library required.

The piece that matters for correctness is :class:`SSESubscriber`: the
recorder's fan-out callback runs on the *resolver* thread and must not
block (see the Session subscriber-exporter contract), while the HTTP
handler writes on its own per-client thread at whatever pace the
client drains.  The subscriber decouples the two with a bounded queue
that drops the *oldest* event on overflow — a slow client loses old
records (counted, surfaced in ``/stats``) instead of back-pressuring
the measurement plane.
"""
from __future__ import annotations

import collections
import threading
from typing import Optional


def format_sse(data: str, event: Optional[str] = None,
               event_id: Optional[str] = None) -> bytes:
    """Frame one SSE message.  ``data`` may span lines; each line gets
    its own ``data:`` field per the spec."""
    out = []
    if event_id is not None:
        out.append(f"id: {event_id}")
    if event is not None:
        out.append(f"event: {event}")
    for line in data.splitlines() or [""]:
        out.append(f"data: {line}")
    return ("\n".join(out) + "\n\n").encode("utf-8")


class SSESubscriber:
    """Bounded hand-off queue between the resolver-thread producer and
    one SSE client's writer thread.

    ``put`` never blocks: on overflow the oldest queued event is
    dropped and counted.  ``get`` blocks up to ``timeout`` so the
    writer loop can interleave keep-alive comments and notice server
    shutdown promptly.
    """

    def __init__(self, maxlen: int = 1024):
        self._buf: collections.deque = collections.deque()
        self._maxlen = int(maxlen)
        self._lock = threading.Lock()
        self._ready = threading.Event()
        self.dropped = 0

    def put(self, item) -> None:
        with self._lock:
            if len(self._buf) >= self._maxlen:
                self._buf.popleft()
                self.dropped += 1
            self._buf.append(item)
            self._ready.set()

    def get(self, timeout: float):
        """Next queued item, or ``None`` after ``timeout`` seconds."""
        if not self._ready.wait(timeout):
            return None
        with self._lock:
            if not self._buf:
                self._ready.clear()
                return None
            item = self._buf.popleft()
            if not self._buf:
                self._ready.clear()
            return item

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)
