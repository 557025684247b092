"""Per-daemon admin socket (reference: src/common/admin_socket.{h,cc} ::
AdminSocket; SURVEY.md §5.5).

A Unix-domain socket served by one background thread.  Protocol: client
sends one JSON object terminated by newline (`{"prefix": "perf dump"}` —
the reference accepts the same shape), server replies with a 4-byte
big-endian length followed by the JSON response, exactly the reference's
framing, so existing tooling habits transfer.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import sys
from threading import Thread
from typing import Callable

from .lockdep import make_lock

Handler = Callable[[dict], object]


class AdminSocket:
    def __init__(self, path: str):
        self.path = path
        self._commands: dict[str, tuple[Handler, str]] = {}
        self._thread: Thread | None = None
        self._sock: socket.socket | None = None
        self._lock = make_lock("common::admin_socket")
        self.register_command("help", self._help, "list available commands")

    # -- registration -----------------------------------------------------
    def register_command(self, prefix: str, handler: Handler, help: str = "") -> None:
        if prefix in self._commands:
            raise ValueError(f"admin socket command {prefix!r} already registered")
        self._commands[prefix] = (handler, help)

    def unregister_command(self, prefix: str) -> None:
        self._commands.pop(prefix, None)

    def _help(self, cmd: dict) -> dict:
        return {p: h for p, (_, h) in sorted(self._commands.items())}

    def execute(self, cmd: dict) -> object:
        """Dispatch one parsed command (also the in-process entry point)."""
        prefix = cmd.get("prefix", "")
        entry = self._commands.get(prefix)
        if entry is None:
            raise KeyError(f"unknown command {prefix!r}; try 'help'")
        return entry[0](cmd)

    # -- server -----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        if os.path.exists(self.path):
            os.unlink(self.path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.path)
        self._sock.listen(8)
        self._thread = Thread(target=self._serve, name="admin_socket", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        # take the socket under the lock (two stop() racers would
        # double-close), close it after release
        with self._lock:
            sock, self._sock = self._sock, None
        if sock is not None:
            # closing the listener does NOT wake a thread blocked in
            # accept() on Linux — poke it with one throwaway connection
            # so the serve loop observes the cleared self._sock and exits
            try:
                with socket.socket(socket.AF_UNIX,
                                   socket.SOCK_STREAM) as poke:
                    poke.settimeout(1.0)
                    poke.connect(self.path)
            except OSError:
                pass
            sock.close()
        if os.path.exists(self.path):
            try:
                os.unlink(self.path)
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _serve(self) -> None:
        while True:
            sock = self._sock
            if sock is None:
                return
            try:
                conn, _ = sock.accept()
            except OSError:  # socket closed by stop()
                return
            if self._sock is None:  # stop()'s wake-up poke, not a client
                conn.close()
                return
            try:
                self._handle(conn)
            except Exception as e:
                # a broken client or a handler bug must not kill the
                # serve loop, but it must not vanish either
                print(f"# admin_socket {self.path}: request failed: "
                      f"{e!r}", file=sys.stderr)
            finally:
                conn.close()

    def _handle(self, conn: socket.socket) -> None:
        # one slow/silent client must not wedge the socket: bound both the
        # wait and the request size
        conn.settimeout(5.0)
        data = b""
        while b"\n" not in data:
            chunk = conn.recv(65536)
            if not chunk:
                break
            data += chunk
            if len(data) > (1 << 20):
                raise ValueError("admin socket request too large")
        line = data.split(b"\n", 1)[0].strip()
        try:
            cmd = json.loads(line) if line else {}
            if isinstance(cmd, str):
                cmd = {"prefix": cmd}
            result = self.execute(cmd)
            body = json.dumps(result, default=str).encode()
        except Exception as e:
            body = json.dumps({"error": str(e)}).encode()
        conn.sendall(struct.pack(">I", len(body)) + body)


def admin_socket_command(path: str, cmd: dict | str, timeout: float = 5.0) -> object:
    """Client side (reference: the `ceph daemon <sock> <cmd>` path)."""
    if isinstance(cmd, str):
        cmd = {"prefix": cmd}
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(path)
        s.sendall(json.dumps(cmd).encode() + b"\n")
        hdr = b""
        while len(hdr) < 4:
            chunk = s.recv(4 - len(hdr))
            if not chunk:
                raise ConnectionError("admin socket closed mid-header")
            hdr += chunk
        (n,) = struct.unpack(">I", hdr)
        body = b""
        while len(body) < n:
            chunk = s.recv(n - len(body))
            if not chunk:
                raise ConnectionError("admin socket closed mid-body")
            body += chunk
        return json.loads(body)
