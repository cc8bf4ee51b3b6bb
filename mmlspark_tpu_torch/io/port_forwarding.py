"""Port forwarding utilities (reference: io/http/PortForwarding.scala —
jsch SSH tunnels used to reach cluster-private services from notebooks).
The port's copy of ``mmlspark_tpu/io/port_forwarding.py``.

Two forms:

* :class:`PortForwarder` — an in-process TCP relay (no SSH): listen on a
  local port, pipe every connection to ``(remote_host, remote_port)``.
  Hermetically testable and enough for same-network hops.
* :func:`ssh_forward` — the reference's actual use case: spawn
  ``ssh -N -L`` for an encrypted tunnel through a bastion, returning the
  managed process.
"""

from __future__ import annotations

import socket
import subprocess
import threading
from typing import List, Optional


class PortForwarder:
    """Threaded local TCP relay to ``(remote_host, remote_port)``.

    ``start()`` binds (port 0 = ephemeral; read ``local_port`` after) and
    serves until ``stop()``. Each accepted connection gets a fresh upstream
    socket and two pump threads, so concurrent clients don't serialize.
    """

    def __init__(self, remote_host: str, remote_port: int,
                 local_host: str = "127.0.0.1", local_port: int = 0,
                 buffer_size: int = 65536):
        self.remote_host = remote_host
        self.remote_port = remote_port
        self.local_host = local_host
        self.local_port = local_port
        self._requested_port = local_port
        self.buffer_size = buffer_size
        self._server: Optional[socket.socket] = None
        self._conns: set = set()          # live relayed sockets
        self._lock = threading.Lock()
        self._stop = threading.Event()

    def start(self) -> "PortForwarder":
        self._stop.clear()                # restartable after stop()
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.local_host, self._requested_port))
        srv.listen(32)
        self.local_port = srv.getsockname()[1]
        self._server = srv
        threading.Thread(target=self._accept_loop, args=(srv,),
                         daemon=True).start()
        return self

    def _accept_loop(self, srv: socket.socket) -> None:
        while not self._stop.is_set():
            try:
                client, _ = srv.accept()
            except OSError:
                return  # listener closed by stop()
            try:
                upstream = socket.create_connection(
                    (self.remote_host, self.remote_port), timeout=10)
            except OSError:
                client.close()
                continue
            with self._lock:
                # a connection accepted in the closing window must not
                # outlive stop(): the stop flag and the registry are checked
                # and updated under one lock, so either stop() sees this
                # pair in _conns and severs it, or we see the flag and drop
                # the pair before any pump starts
                if self._stop.is_set():
                    client.close()
                    upstream.close()
                    return
                self._conns |= {client, upstream}
            for a, b in ((client, upstream), (upstream, client)):
                threading.Thread(target=self._pump, args=(a, b),
                                 daemon=True).start()

    def _pump(self, src: socket.socket, dst: socket.socket) -> None:
        try:
            while True:
                data = src.recv(self.buffer_size)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            # half-close so the peer's pump drains whatever is in flight
            for s, how in ((dst, socket.SHUT_WR), (src, socket.SHUT_RD)):
                try:
                    s.shutdown(how)
                except OSError:
                    pass
            with self._lock:
                self._conns.discard(src)

    def stop(self) -> None:
        """Stop listening AND sever established connections — a stopped
        forwarder relays nothing and leaves no pump thread blocked."""
        self._stop.set()
        if self._server is not None:
            self._server.close()
        with self._lock:
            conns, self._conns = self._conns, set()
        for s in conns:
            # shutdown first: close() alone doesn't wake a thread blocked in
            # recv() on the same socket
            for op in (lambda: s.shutdown(socket.SHUT_RDWR), s.close):
                try:
                    op()
                except OSError:
                    pass

    def __enter__(self) -> "PortForwarder":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def ssh_forward(ssh_host: str, remote_host: str, remote_port: int,
                local_port: int, ssh_user: Optional[str] = None,
                key_file: Optional[str] = None,
                extra_args: Optional[List[str]] = None) -> subprocess.Popen:
    """Spawn ``ssh -N -L local:remote`` (the reference's jsch tunnel as a
    managed subprocess). Caller owns the returned process: ``terminate()``
    to tear the tunnel down."""
    target = f"{ssh_user}@{ssh_host}" if ssh_user else ssh_host
    cmd = ["ssh", "-N",
           "-o", "ExitOnForwardFailure=yes",
           "-L", f"{local_port}:{remote_host}:{remote_port}"]
    if key_file:
        cmd += ["-i", key_file]
    cmd += (extra_args or []) + [target]
    return subprocess.Popen(cmd)
