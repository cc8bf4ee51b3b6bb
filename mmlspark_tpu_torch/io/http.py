"""HTTP helpers of the port: :func:`to_jsonable` and the gateway's
keep-alive connection pool.

Counterpart of ``to_jsonable``, ``_KeepAliveConnection`` and
``HTTPConnectionPool`` in ``mmlspark_tpu/io/http.py``; the rest of that
module (``HTTPTransformer``, the clients, the request and response
schema) is not ported yet.
"""

from __future__ import annotations

import http.client
import threading
from typing import Any, Dict, List, Optional

import numpy as np


def to_jsonable(v: Any) -> Any:
    """numpy scalars/arrays, bytes, containers -> JSON-able python values.
    Shared by the serving replies of both engines."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, dict):
        return {k: to_jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [to_jsonable(x) for x in v]
    return v


class _KeepAliveConnection(http.client.HTTPConnection):
    """HTTPConnection with Nagle disabled: on a persistent connection a
    request written as two small segments (headers, then body) hits the
    Nagle/delayed-ACK interaction — a ~40 ms stall PER REQUEST that a
    fresh HTTP/1.0 connection never showed. TCP_NODELAY restores
    sub-millisecond turnaround on the pooled hop."""

    def connect(self):
        super().connect()
        import socket
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class HTTPConnectionPool:
    """Bounded keep-alive pool of ``http.client`` connections per
    (host, port) — the reference shared one Apache ``HttpClient`` (with
    its pooling connection manager) per executor JVM
    (HTTPClients.scala:20); this is the same amortization for the
    framework's hot proxy hop. One TCP handshake serves many requests;
    ``acquire`` hands out an idle pooled connection (``reused=True``) or
    a fresh one, ``release`` returns it for the next request.

    A pooled socket can go stale (the far end closed its keep-alive side
    between requests); callers observe that as a connection-level error
    on a *reused* connection and retry on a fresh one — the gateway's
    ``_exchange`` does exactly this. Connections are never shared
    concurrently: acquire pops, release pushes."""

    def __init__(self, max_per_host: int = 4):
        self.max_per_host = max_per_host
        self._lock = threading.Lock()
        self._idle: Dict[tuple, List[http.client.HTTPConnection]] = {}
        self._closed = False

    def acquire(self, host: str, port: int, timeout: float):
        """``(conn, reused)`` — a pooled keep-alive connection when one
        is idle, else a fresh (not-yet-connected) one."""
        with self._lock:
            stack = self._idle.get((host, port))
            conn = stack.pop() if stack else None
        if conn is not None:
            conn.timeout = timeout
            try:
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
                return conn, True
            except OSError:      # fd died while pooled: fall through fresh
                conn.close()
        return _KeepAliveConnection(host, port, timeout=timeout), False

    def release(self, host: str, port: int,
                conn: http.client.HTTPConnection,
                reusable: bool = True) -> None:
        """Return a connection after a fully-read response; it is pooled
        unless the far end announced close (``resp.will_close``) or the
        per-host pool is full."""
        if reusable:
            with self._lock:
                # a release racing close() (an in-flight exchange
                # finishing after the owner stopped) must not repopulate
                # an orphaned pool — that socket would leak forever
                if not self._closed:
                    stack = self._idle.setdefault((host, port), [])
                    if len(stack) < self.max_per_host:
                        stack.append(conn)
                        return
        conn.close()

    def clear(self, host: Optional[str] = None,
              port: Optional[int] = None) -> None:
        """Close idle connections — one host's (a worker that left the
        registry or hard-failed: its pooled sockets are dead weight) or
        all of them."""
        with self._lock:
            if host is None:
                conns = [c for s in self._idle.values() for c in s]
                self._idle.clear()
            else:
                conns = list(self._idle.pop((host, port), ()))
        for c in conns:
            c.close()

    def close(self) -> None:
        """Shut the pool for good: closes every idle connection and
        makes any straggler ``release`` close instead of pool."""
        with self._lock:
            self._closed = True
        self.clear()

    def idle_count(self, host: str, port: int) -> int:
        with self._lock:
            return len(self._idle.get((host, port), ()))
