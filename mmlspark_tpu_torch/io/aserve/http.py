"""Loop-native HTTP/1.1: the async engine's reader and response funnel.

No ``http.server`` anywhere on this path — requests are parsed straight
off the ``asyncio.StreamReader`` and responses leave through ONE funnel
(:func:`write_response`), which owns the status line, Content-Length,
keep-alive headers, and the per-status counter exactly like the
threaded engine's ``write_http_response`` does (same accounting, no
handler branch can skip it).

Keep-alive is the default (HTTP/1.1): the whole point of the async
front is that a client holds one connection and streams requests down
it instead of paying a TCP handshake + handler thread per request.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, Optional

from ...observability import metrics as _metrics

#: parse hardening: a request line / header block past these bounds is
#: answered 400/431 instead of buffered without limit
MAX_HEADERS = 128
MAX_BODY_BYTES = 64 * 1024 * 1024

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    408: "Request Timeout", 413: "Payload Too Large",
    429: "Too Many Requests", 431: "Request Header Fields Too Large",
    500: "Internal Server Error", 502: "Bad Gateway",
    503: "Service Unavailable", 504: "Gateway Timeout",
}


class ParsedRequest:
    """One request off the wire (headers lower-cased, body fully read)."""

    __slots__ = ("method", "path", "headers", "body", "keep_alive")

    def __init__(self, method: str, path: str, headers: Dict[str, str],
                 body: bytes, keep_alive: bool):
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body
        self.keep_alive = keep_alive


class BadRequest(Exception):
    """Malformed wire input; ``status`` is what the caller answers."""

    def __init__(self, status: int, reason: str):
        super().__init__(reason)
        self.status = status


async def read_request(reader: asyncio.StreamReader
                       ) -> Optional[ParsedRequest]:
    """Parse one request; None on a cleanly closed connection (EOF
    before any bytes — the keep-alive end-of-stream), :class:`BadRequest`
    on malformed input."""
    try:
        line = await reader.readline()
    except ConnectionError:
        return None
    except ValueError:
        # StreamReader.readline converts LimitOverrunError to ValueError
        # — an over-limit request line must answer, not drop the task
        raise BadRequest(431, "request line too long") from None
    if not line:
        return None
    parts = line.decode("latin-1").strip().split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/"):
        raise BadRequest(400, "malformed request line")
    method, path, version = parts
    headers: Dict[str, str] = {}
    for _ in range(MAX_HEADERS + 1):
        try:
            h = await reader.readline()
        except ValueError:
            raise BadRequest(431, "header line too long") from None
        if h in (b"\r\n", b"\n"):
            break
        if not h:
            raise BadRequest(400, "connection closed mid-headers")
        key, sep, value = h.decode("latin-1").partition(":")
        if not sep:
            raise BadRequest(400, "malformed header line")
        headers[key.strip().lower()] = value.strip()
    else:
        raise BadRequest(431, "too many headers")
    try:
        length = int(headers.get("content-length") or 0)
    except ValueError:
        raise BadRequest(400, "bad Content-Length") from None
    if length > MAX_BODY_BYTES:
        raise BadRequest(413, "body too large")
    body = b""
    if length:
        try:
            body = await reader.readexactly(length)
        except asyncio.IncompleteReadError:
            raise BadRequest(400, "connection closed mid-body") from None
    conn = headers.get("connection", "").lower()
    keep_alive = (conn != "close" if version == "HTTP/1.1"
                  else conn == "keep-alive")
    return ParsedRequest(method, path, headers, body, keep_alive)


def format_response(status: int, payload: bytes = b"",
                    headers: Optional[Dict[str, str]] = None,
                    keep_alive: bool = True) -> bytes:
    if isinstance(payload, str):
        payload = payload.encode("utf-8")
    reason = _REASONS.get(status, "")
    out = [f"HTTP/1.1 {status} {reason}".encode("latin-1")]
    for k, v in (headers or {}).items():
        out.append(f"{k}: {v}".encode("latin-1"))
    out.append(b"Content-Length: " + str(len(payload)).encode())
    out.append(b"Connection: " + (b"keep-alive" if keep_alive
                                  else b"close"))
    return b"\r\n".join(out) + b"\r\n\r\n" + payload


async def write_response(writer: asyncio.StreamWriter, status: int,
                         payload: bytes = b"",
                         headers: Optional[Dict[str, str]] = None,
                         keep_alive: bool = True,
                         counter: Optional[str] = None,
                         **labels: Any) -> None:
    """The async engine's single response funnel — every reply's bytes
    (and its per-status counter, when ``counter`` is given) leave
    through here, mirroring ``serving.write_http_response``."""
    writer.write(format_response(status, payload, headers, keep_alive))
    await writer.drain()
    if counter:
        _metrics.safe_counter(counter, code=str(status), **labels).inc()
