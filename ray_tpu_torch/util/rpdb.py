"""Remote pdb: breakpoints in cluster tasks, attached to from the CLI.

Reference: python/ray/util/rpdb.py (`ray.util.pdb.set_trace` opens a
socket-backed pdb in the worker and registers itself so `ray debug`
(scripts.py) can list and attach to active breakpoints).

Same shape here: `ray_tpu_torch.util.rpdb.set_trace()` inside a task/actor
method opens a TCP listener, registers {host, port, task, pid} in the
GCS KV under ns="debugger", and blocks until a client attaches. The CLI
(`ray_tpu_torch debug --address ...`) lists sessions and bridges the terminal
to the socket. Plain pdb protocol — `telnet host port` works too.
"""

from __future__ import annotations

import pdb
import socket
import sys
import time
from typing import List, Optional

NS = "debugger"


class _SockIO:
    """File-like adapter over a socket for pdb's stdin/stdout."""

    def __init__(self, conn: socket.socket):
        self.conn = conn
        self._rfile = conn.makefile("r", encoding="utf-8", newline="\n")

    def readline(self, *a):
        return self._rfile.readline(*a)

    def write(self, s: str):
        try:
            self.conn.sendall(s.encode("utf-8"))
        except OSError:
            pass
        return len(s)

    def flush(self):
        pass


class _RemotePdb(pdb.Pdb):
    def __init__(self, conn: socket.socket):
        io = _SockIO(conn)
        super().__init__(stdin=io, stdout=io)
        self.use_rawinput = False
        self.prompt = "(ray_tpu_torch-pdb) "


def _kv_call(method: str, **kw):
    from ray_tpu_torch import _rt

    return _rt.get_runtime().gcs_call(method, **kw)


def _advertised_host() -> str:
    """The worker runtime's routable address (a container hostname often
    doesn't resolve from the CLI machine)."""
    try:
        from ray_tpu_torch import _rt

        return _rt.get_runtime().address.addr[0]
    except Exception:
        return socket.gethostname()


def set_trace(frame=None):
    """Open a breakpoint server and wait for a debugger client
    (ref: rpdb.set_trace). Blocks the task until the client detaches.

    The listener requires a per-breakpoint token as its first line —
    the token lives in the GCS KV, so attach rights == cluster-KV
    access; an unauthenticated socket would be remote code execution
    for anyone who can reach the worker."""
    import json
    import os
    import secrets

    srv = socket.socket()
    srv.bind(("0.0.0.0", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    host = _advertised_host()
    token = secrets.token_hex(16)
    key = f"bp_{host}_{port}".encode()
    info = {"host": host, "port": port, "pid": os.getpid(),
            "ts": time.time(), "token": token}
    try:
        _kv_call("kv_put", ns=NS, key=key,
                 value=json.dumps(info).encode())
    except Exception:
        pass
    conn = None
    try:
        while conn is None:
            c, _ = srv.accept()
            line = c.makefile("r").readline().strip()
            if line == token:
                conn = c
            else:
                try:
                    c.sendall(b"bad token\n")
                    c.close()
                except OSError:
                    pass
    finally:
        srv.close()
        try:
            _kv_call("kv_del", ns=NS, key=key)
        except Exception:
            pass
    dbg = _RemotePdb(conn)
    dbg.set_trace(frame or sys._getframe().f_back)


def list_breakpoints() -> List[dict]:
    """Active breakpoint sessions from the GCS KV (ref: `ray debug`
    session listing)."""
    import json

    out = []
    try:
        keys = _kv_call("kv_keys", ns=NS)
    except Exception:
        return out
    for k in keys:
        try:
            v = _kv_call("kv_get", ns=NS, key=k)
            if v:
                out.append(json.loads(v))
        except Exception:
            pass
    return out


def attach(host: str, port: int, *, token: str = "", stdin=None,
           stdout=None):
    """Bridge the local terminal to a breakpoint server (ref: `ray
    debug` attach loop). Returns when the remote side closes."""
    import threading

    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    conn = socket.create_connection((host, port))
    conn.sendall((token + "\n").encode())

    def pump_out():
        while True:
            try:
                data = conn.recv(4096)
            except OSError:
                return
            if not data:
                return
            stdout.write(data.decode("utf-8", errors="replace"))
            stdout.flush()

    t = threading.Thread(target=pump_out, daemon=True)
    t.start()
    try:
        for line in stdin:
            try:
                conn.sendall(line.encode("utf-8"))
            except OSError:
                break
            if line.strip() in ("c", "continue", "q", "quit", "exit"):
                break
    finally:
        time.sleep(0.2)
        try:
            conn.close()
        except Exception:
            pass
