"""STOMP 1.2 — stdlib-only client + mini broker for the durable tier.

The reference's durable outputs (completed-call CDRs, metadata updates)
ride ActiveMQ through the ``stompest`` package (client_activemq.py):
JSON bodies, ``persistent: true/false`` plus ``time_queued`` /
``time_sent`` latency headers on SEND (client_activemq.py:144-166), and
auto-ack subscriptions keyed by a per-subscription UUID id
(client_activemq.py:104-126).  This module speaks that wire protocol
directly — same pattern as the RESP layer (control/resp.py): a frame
codec, a client with a reader thread + reconnect-resubscribe, and an
in-process mini broker so the durable path is testable (and deployable
single-box) without operating ActiveMQ.  Against a real ActiveMQ /
Artemis / RabbitMQ-STOMP broker the client is wire-compatible.

Frame format (STOMP 1.2): ``COMMAND\\n`` then ``header:value\\n`` lines,
blank line, body, NUL.  ``content-length`` is always sent so JSON
bodies may contain NULs-free arbitrary text; header values are encoded
with the 1.2 escape set (``\\n`` ``\\c`` ``\\\\``).
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import time
import uuid as _uuid

log = logging.getLogger(__name__)

_HDR_ESC = (("\\", "\\\\"), ("\n", "\\n"), (":", "\\c"), ("\r", "\\r"))


def _esc(s: str) -> str:
    for ch, rep in _HDR_ESC:
        s = s.replace(ch, rep)
    return s


def _unesc(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            out.append({"n": "\n", "c": ":", "r": "\r",
                        "\\": "\\"}.get(s[i + 1], s[i + 1]))
            i += 2
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


def encode_frame(command: str, headers: dict | None = None,
                 body: bytes = b"") -> bytes:
    lines = [command]
    hdrs = dict(headers or {})
    if body and "content-length" not in hdrs:
        hdrs["content-length"] = len(body)
    for k, v in hdrs.items():
        lines.append(f"{_esc(str(k))}:{_esc(str(v))}")
    return ("\n".join(lines) + "\n\n").encode() + body + b"\x00"


class _Incomplete(Exception):
    pass


def _parse_hb(v: str) -> tuple[int, int]:
    """'sx,sy' heart-beat header → ints (malformed → 0,0 = disabled)."""
    try:
        a, b = str(v).split(",", 1)
        return max(0, int(a)), max(0, int(b))
    except ValueError:
        return 0, 0


def parse_frame(buf: bytes, pos: int):
    """One frame from ``buf[pos:]`` → ((command, headers, body), newpos);
    raises _Incomplete when more bytes are needed.  Heart-beat EOLs
    between frames are skipped."""
    while pos < len(buf) and buf[pos:pos + 1] in (b"\n", b"\r"):
        pos += 1
    if pos >= len(buf):
        raise _Incomplete
    head_end = buf.find(b"\n\n", pos)
    if head_end < 0:
        raise _Incomplete
    head = buf[pos:head_end].decode(errors="replace").split("\n")
    command = head[0].rstrip("\r")
    headers: dict = {}
    for line in head[1:]:
        line = line.rstrip("\r")
        if ":" not in line:
            continue
        k, v = line.split(":", 1)
        headers.setdefault(_unesc(k), _unesc(v))   # first value wins
    body_start = head_end + 2
    if "content-length" in headers:
        try:
            n = int(headers["content-length"])
        except ValueError:
            raise ConnectionError("bad STOMP content-length")
        if n < 0 or n > (1 << 29):
            raise ConnectionError(f"unreasonable STOMP body length {n}")
        if len(buf) < body_start + n + 1:
            raise _Incomplete
        if buf[body_start + n:body_start + n + 1] != b"\x00":
            raise ConnectionError("missing frame NUL")
        return (command, headers, buf[body_start:body_start + n]), \
            body_start + n + 1
    nul = buf.find(b"\x00", body_start)
    if nul < 0:
        raise _Incomplete
    return (command, headers, buf[body_start:nul]), nul + 1


class StompClient:
    """Minimal STOMP 1.2 client: CONNECT/SEND/SUBSCRIBE/ACK with a
    reader thread, auto-reconnect, and re-subscribe on reconnect
    (the reference re-subscribes everything from its handler thread,
    client_activemq.py:82-103).

    Heart-beats are negotiated per the 1.2 spec (the reference asks
    stompest for them too, client_activemq.py:70,99): ``heartbeat`` is
    the (cx, cy) ms pair offered on CONNECT — we can send every cx, we
    want to hear every cy; the CONNECTED reply's (sx, sy) yields an
    outgoing EOL cadence of max(cx, sy) and a dead-broker detector at
    2·max(cy, sx) of silence, which turns a half-open TCP connection
    (broker host drops off the network mid-call) into a reconnect
    instead of an indefinitely-stuck durable tier."""

    def __init__(self, host: str = "localhost", port: int = 61613,
                 reconnect_s: float = 0.5, vhost: str = "/",
                 heartbeat: tuple[int, int] = (10000, 10000)):
        self.host, self.port = host, port
        self.vhost = vhost
        self.reconnect_s = reconnect_s
        self.heartbeat = (int(heartbeat[0]), int(heartbeat[1]))
        self.connection_issue = True
        self.connects = 0
        self.heartbeat_timeouts = 0
        self._send_every = 0.0    # negotiated outgoing period (s)
        self._recv_within = 0.0   # negotiated incoming deadline (s)
        self._last_sent = 0.0
        self._last_recv = 0.0
        self._subs: dict[str, tuple[str, object]] = {}  # dest->(id, cb)
        self._receipts: dict[str, threading.Event] = {}
        self._lock = threading.Lock()
        # Serializes every writer on the socket (send()/subscribe()
        # from caller threads, heart-beat EOLs from the reader thread):
        # interleaving a concurrent sendall mid-frame would corrupt the
        # stream.
        self._wlock = threading.Lock()
        self._sock: socket.socket | None = None
        self._running = True
        self._connected = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"stomp-{host}:{port}")
        self._thread.start()

    def wait_connected(self, timeout: float = 5.0) -> bool:
        return self._connected.wait(timeout)

    # ---- verbs ----
    def send(self, destination: str, body: bytes | str,
             headers: dict | None = None) -> None:
        """SEND; raises ConnectionError when not connected (callers own
        retry policy, like the RESP client)."""
        if isinstance(body, str):
            body = body.encode()
        hdrs = {"destination": destination, **(headers or {})}
        with self._lock:
            s = self._sock
        if s is None:
            raise ConnectionError("not connected")
        try:
            with self._wlock:
                s.sendall(encode_frame("SEND", hdrs, body))
                self._last_sent = time.monotonic()
        except OSError as e:
            raise ConnectionError(str(e)) from e

    def send_with_receipt(self, destination: str, body: bytes | str,
                          headers: dict | None = None,
                          timeout: float = 5.0) -> bool:
        """SEND with a ``receipt`` header; True once the broker's
        RECEIPT frame arrives — the durable tier's delivery handshake
        (a plain SEND only proves the kernel accepted the bytes)."""
        rid = str(_uuid.uuid4())
        ev = threading.Event()
        with self._lock:
            self._receipts[rid] = ev
        try:
            self.send(destination, body,
                      {**(headers or {}), "receipt": rid})
            return ev.wait(timeout)
        finally:
            with self._lock:
                self._receipts.pop(rid, None)

    def subscribe(self, destination: str, callback) -> str:
        """callback(headers, body_bytes); auto-ack like the reference
        (StompSpec.ACK_AUTO).  Returns the subscription id."""
        sid = str(_uuid.uuid4())
        with self._lock:
            self._subs[destination] = (sid, callback)
            s = self._sock
        if s is not None:
            try:
                with self._wlock:
                    s.sendall(encode_frame("SUBSCRIBE", {
                        "id": sid, "destination": destination,
                        "ack": "auto"}))
                    self._last_sent = time.monotonic()
            except OSError:
                pass
        return sid

    def unsubscribe(self, destination: str) -> None:
        with self._lock:
            ent = self._subs.pop(destination, None)
            s = self._sock
        if ent and s is not None:
            try:
                with self._wlock:
                    s.sendall(encode_frame("UNSUBSCRIBE",
                                           {"id": ent[0]}))
                    self._last_sent = time.monotonic()
            except OSError:
                pass

    # ---- reader ----
    def _run(self) -> None:
        while self._running:
            try:
                s = socket.create_connection((self.host, self.port),
                                             timeout=5.0)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.settimeout(0.5)
                cx, cy = self.heartbeat
                s.sendall(encode_frame("CONNECT", {
                    "accept-version": "1.2", "host": self.vhost,
                    "heart-beat": f"{cx},{cy}"}))
                buf = b""
                self._last_recv = time.monotonic()
                frame, buf = self._read_frame(s, buf)
                if frame[0] != "CONNECTED":
                    raise ConnectionError(f"broker said {frame[0]}")
                sx, sy = _parse_hb(frame[1].get("heart-beat", "0,0"))
                self._send_every = (max(cx, sy) / 1e3
                                    if cx and sy else 0.0)
                self._recv_within = (max(cy, sx) / 1e3
                                     if cy and sx else 0.0)
                with self._lock:
                    self._sock = s
                    subs = list(self._subs.items())
                for dest, (sid, _cb) in subs:
                    s.sendall(encode_frame("SUBSCRIBE", {
                        "id": sid, "destination": dest, "ack": "auto"}))
                self.connects += 1
                self.connection_issue = False
                self._connected.set()
                self._last_sent = self._last_recv = time.monotonic()
                while self._running:
                    # heart-beat bookkeeping runs on EVERY wakeup — a
                    # continuously busy receive direction must not
                    # starve our outgoing beats (the peer would kill a
                    # healthy connection at its 2x deadline).
                    now = time.monotonic()
                    if self._send_every and \
                            now - self._last_sent >= self._send_every:
                        with self._wlock:
                            s.sendall(b"\n")       # heart-beat EOL
                            self._last_sent = time.monotonic()
                    if self._recv_within and \
                            now - self._last_recv > \
                            2 * self._recv_within:
                        self.heartbeat_timeouts += 1
                        raise ConnectionError(
                            "heart-beat timeout (broker silent "
                            f"{now - self._last_recv:.1f} s)")
                    try:
                        frame, buf = self._read_frame(s, buf)
                    except socket.timeout:
                        continue
                    cmd, headers, body = frame
                    if cmd == "MESSAGE":
                        self._dispatch(headers, body)
                    elif cmd == "RECEIPT":
                        with self._lock:
                            ev = self._receipts.get(
                                headers.get("receipt-id", ""))
                        if ev is not None:
                            ev.set()
                    elif cmd == "ERROR":
                        log.warning("STOMP ERROR: %s",
                                    headers.get("message"))
            except (OSError, ConnectionError) as e:
                self.connection_issue = True
                self._connected.clear()
                with self._lock:
                    self._sock = None
                if self._running:
                    log.debug("stomp reconnect after: %s", e)
                    time.sleep(self.reconnect_s)

    def _read_frame(self, s: socket.socket, buf: bytes):
        """Resumable frame read: bytes only consumed once complete
        (socket timeouts preserve the buffered prefix). Any received
        bytes — including bare heart-beat EOLs — refresh the liveness
        clock."""
        while True:
            try:
                frame, pos = parse_frame(buf, 0)
                return frame, buf[pos:]
            except _Incomplete:
                chunk = s.recv(65536)
                if not chunk:
                    raise ConnectionError("peer closed")
                self._last_recv = time.monotonic()
                buf += chunk

    def _dispatch(self, headers: dict, body: bytes) -> None:
        dest = headers.get("destination", "")
        with self._lock:
            ent = self._subs.get(dest)
        if ent is None:
            return
        try:
            ent[1](headers, body)
        except Exception:
            log.exception("stomp callback error on %s", dest)

    def close(self) -> None:
        self._running = False
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.sendall(encode_frame("DISCONNECT"))
                except OSError:
                    pass
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


class StompBus:
    """The control-plane Bus API over STOMP — drop-in for
    InProcBus/RedisBus where a site publishes its durable tier into an
    existing ActiveMQ deployment (the reference's
    ``/queue/call_management/call_complete`` consumer contract,
    logging_receiver.py:550, client_activemq.py:144-169).

    - lazy tier: SEND with ``persistent: false``; dropped when down.
    - hopeful tier: SEND with ``persistent: true`` **confirmed by a
      broker RECEIPT** (a bare SEND only proves the kernel took the
      bytes), queued and drained with requeue-at-head on failure
      (reconnect-requeue).
    - both carry the reference's ``time_queued``/``time_sent`` latency
      headers; deliveries older than ``latency_warn_s`` are counted.
    - heart-beats negotiated on by default (StompClient.heartbeat) so a
      half-open broker connection reconnects instead of wedging.
    """

    def __init__(self, host: str = "localhost", port: int = 61613,
                 latency_warn_s: float = 0.1, retry_s: float = 0.25,
                 heartbeat: tuple[int, int] = (10000, 10000),
                 receipt_timeout_s: float = 5.0):
        self.client = StompClient(host, port, reconnect_s=retry_s,
                                  heartbeat=heartbeat)
        self.receipt_timeout_s = receipt_timeout_s
        self.latency_warn_s = latency_warn_s
        self.latency_warnings = 0
        self.retry_s = retry_s
        self._running = True
        self._hopeful: list[tuple[str, dict, str]] = []
        self._cv = threading.Condition()
        self._inflight = 0
        self._drain = threading.Thread(target=self._drain_hopeful,
                                       daemon=True, name="stomp-drain")
        self._drain.start()

    @property
    def connection_issue(self) -> bool:
        return self.client.connection_issue

    @staticmethod
    def _headers(persistent: bool, headers: dict | None) -> dict:
        return {"persistent": "true" if persistent else "false",
                "content-type": "application/json",
                "time_queued": time.time(), **(headers or {})}

    def send_event_lazy(self, dest: str, body: dict,
                        headers: dict | None = None) -> None:
        h = self._headers(False, headers)
        h["time_sent"] = time.time()
        try:
            self.client.send(dest, json.dumps(body), h)
        except ConnectionError:
            pass                       # lossy tier drops

    def send_event_hopeful(self, dest: str, body: dict,
                           headers: dict | None = None) -> None:
        with self._cv:
            self._hopeful.append((dest, self._headers(True, headers),
                                  json.dumps(body)))
            self._cv.notify()

    #: receipted sends in flight per drain round — pipelines the
    #: broker round-trips instead of paying one RTT per message (a
    #: serialized drain caps throughput at 1/RTT msgs/s).
    RECEIPT_WINDOW = 16

    def _drain_hopeful(self) -> None:
        import uuid as _uuid2
        while self._running:
            with self._cv:
                if not self._hopeful:
                    self._cv.wait(timeout=0.5)
                    continue
                batch = self._hopeful[:self.RECEIPT_WINDOW]
                del self._hopeful[:len(batch)]
                self._inflight += len(batch)
            pend = []      # (event, dest, hdrs, data) awaiting RECEIPT
            failed = []
            for dest, hdrs, data in batch:
                if failed:              # keep order once one send fails
                    failed.append((dest, hdrs, data))
                    continue
                rid = str(_uuid2.uuid4())
                ev = threading.Event()
                with self.client._lock:
                    self.client._receipts[rid] = ev
                try:
                    hdrs["time_sent"] = time.time()
                    self.client.send(dest, data,
                                     {**hdrs, "receipt": rid})
                    pend.append((ev, dest, hdrs, data))
                except Exception:
                    with self.client._lock:
                        self.client._receipts.pop(rid, None)
                    failed.append((dest, hdrs, data))
            deadline = time.monotonic() + self.receipt_timeout_s
            confirmed = 0
            still = []
            for ev, dest, hdrs, data in pend:
                if ev.wait(max(0.0, deadline - time.monotonic())):
                    confirmed += 1
                else:
                    still.append((dest, hdrs, data))
            with self.client._lock:
                self.client._receipts = {
                    r: e for r, e in self.client._receipts.items()
                    if not e.is_set()}
            requeue = still + failed
            with self._cv:
                if requeue:
                    # at-least-once: unconfirmed items retry in order
                    self._hopeful[:0] = requeue
                self._inflight -= len(batch)
            if requeue:
                time.sleep(self.retry_s)

    def subscribe(self, dest: str, callback) -> None:
        def on_msg(headers: dict, body: bytes, cb=callback):
            try:
                payload = json.loads(body)
            except Exception:
                return
            tq = headers.get("time_queued")
            try:
                if tq and time.time() - float(tq) > self.latency_warn_s:
                    self.latency_warnings += 1
            except ValueError:
                pass
            cb(payload)
        self.client.subscribe(dest, on_msg)

    def unsubscribe(self, dest: str, callback=None) -> None:
        self.client.unsubscribe(dest)

    def flush(self, timeout: float = 5.0) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._cv:
                if not self._hopeful and self._inflight == 0:
                    return True
            time.sleep(0.01)
        return False

    def close(self) -> None:
        self._running = False
        self.client.close()


class MiniStompServer:
    """In-process STOMP 1.2 broker for tests/single-box deployments:
    CONNECT/CONNECTED, SEND routing, SUBSCRIBE fan-out for ``/topic/*``,
    queue semantics for ``/queue/*`` (persistent SENDs are retained
    until a subscriber exists, then delivered round-robin), RECEIPT
    for any frame carrying a ``receipt`` header, heart-beat negotiation
    + emission + client-liveness enforcement (ActiveMQ's first-contact
    behaviors), DISCONNECT. ``drop_connections()`` simulates a broker
    bounce.

    ``heartbeat`` is the broker's (sx, sy) CONNECTED offer; like
    ActiveMQ, a negotiated-silent client is disconnected after 2× the
    incoming deadline."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 heartbeat: tuple[int, int] = (5000, 5000)):
        self.heartbeat = (int(heartbeat[0]), int(heartbeat[1]))
        self.hb_disconnects = 0
        self._lock = threading.RLock()
        # dest -> [(conn, sub_id, send_lock)]
        self._subs: dict[str, list] = {}
        self._queues: dict[str, list[tuple[dict, bytes]]] = {}
        self._rr: dict[str, int] = {}
        self.frames: list[tuple[str, dict]] = []    # (command, headers)
        self._running = True
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(0.25)
        self.host, self.port = self._srv.getsockname()[:2]
        self._conns: list[socket.socket] = []
        threading.Thread(target=self._accept, daemon=True,
                         name="ministomp").start()

    def _accept(self) -> None:
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()
        my_subs: list[tuple[str, str]] = []
        buf = b""
        conn.settimeout(0.25)
        sx, sy = self.heartbeat
        send_every = recv_within = 0.0
        last_sent = last_recv = time.monotonic()
        try:
            while self._running:
                now = time.monotonic()
                # checked on EVERY wakeup: a busy receive direction
                # must not starve outgoing beats or liveness checks
                if send_every and now - last_sent >= send_every:
                    with send_lock:
                        conn.sendall(b"\n")
                    last_sent = time.monotonic()
                if recv_within and now - last_recv > 2 * recv_within:
                    self.hb_disconnects += 1
                    return   # client presumed dead (ActiveMQ)
                try:
                    frame, pos = parse_frame(buf, 0)
                    buf = buf[pos:]
                except _Incomplete:
                    try:
                        chunk = conn.recv(65536)
                    except socket.timeout:
                        continue
                    if not chunk:
                        return
                    last_recv = time.monotonic()
                    buf += chunk
                    continue
                cmd, headers, body = frame
                self.frames.append((cmd, headers))
                if cmd in ("CONNECT", "STOMP"):
                    cx, cy = _parse_hb(headers.get("heart-beat", "0,0"))
                    send_every = (max(sx, cy) / 1e3
                                  if sx and cy else 0.0)
                    recv_within = (max(sy, cx) / 1e3
                                   if sy and cx else 0.0)
                    with send_lock:
                        conn.sendall(encode_frame(
                            "CONNECTED", {"version": "1.2",
                                          "heart-beat": f"{sx},{sy}"}))
                    last_sent = time.monotonic()
                elif cmd == "SUBSCRIBE":
                    dest = headers.get("destination", "")
                    sid = headers.get("id", "")
                    with self._lock:
                        self._subs.setdefault(dest, []).append(
                            (conn, sid, send_lock))
                        my_subs.append((dest, sid))
                        backlog = (self._queues.pop(dest, [])
                                   if dest.startswith("/queue/") else [])
                    for h, b in backlog:
                        self._deliver(dest, h, b)
                elif cmd == "UNSUBSCRIBE":
                    sid = headers.get("id", "")
                    with self._lock:
                        for dest in list(self._subs):
                            self._subs[dest] = [
                                e for e in self._subs[dest]
                                if not (e[0] is conn and e[1] == sid)]
                elif cmd == "SEND":
                    self._route(headers, body)
                rid = headers.get("receipt")
                if rid is not None:     # RECEIPT for any receipted frame
                    with send_lock:
                        conn.sendall(encode_frame(
                            "RECEIPT", {"receipt-id": rid}))
                    last_sent = time.monotonic()
                if cmd == "DISCONNECT":
                    return
        except OSError:
            pass
        finally:
            with self._lock:
                for dest, sid in my_subs:
                    self._subs[dest] = [
                        e for e in self._subs.get(dest, [])
                        if e[0] is not conn]
            try:
                conn.close()
            except OSError:
                pass

    def _route(self, headers: dict, body: bytes) -> None:
        dest = headers.get("destination", "")
        with self._lock:
            has_subs = bool(self._subs.get(dest))
            if not has_subs:
                if (dest.startswith("/queue/")
                        and headers.get("persistent") == "true"):
                    self._queues.setdefault(dest, []).append(
                        (headers, body))    # retained for a consumer
                return
        self._deliver(dest, headers, body)

    def _deliver(self, dest: str, headers: dict, body: bytes) -> None:
        with self._lock:
            subs = list(self._subs.get(dest, []))
            if not subs:
                if dest.startswith("/queue/"):
                    self._queues.setdefault(dest, []).append(
                        (headers, body))
                return
            if dest.startswith("/queue/"):     # one consumer, round-robin
                i = self._rr.get(dest, 0) % len(subs)
                self._rr[dest] = i + 1
                subs = [subs[i]]
        for conn, sid, slock in subs:
            msg = {"destination": dest, "message-id": str(_uuid.uuid4()),
                   "subscription": sid,
                   **{k: v for k, v in headers.items()
                      if k not in ("destination",)}}
            try:
                with slock:
                    conn.sendall(encode_frame("MESSAGE", msg, body))
            except OSError:
                # includes socket.timeout: a partial sendall leaves the
                # stream desynced mid-frame — drop the subscriber whole
                # (its client reconnects cleanly) instead of appending
                # the next MESSAGE into a torn frame.
                with self._lock:
                    for d in list(self._subs):
                        self._subs[d] = [e for e in self._subs[d]
                                         if e[0] is not conn]
                try:
                    conn.close()
                except OSError:
                    pass

    def queued(self, dest: str) -> list[tuple[dict, bytes]]:
        with self._lock:
            return list(self._queues.get(dest, []))

    def drop_connections(self) -> None:
        conns, self._conns = self._conns, []
        with self._lock:
            self._subs = {d: [e for e in subs if e[0] not in conns]
                          for d, subs in self._subs.items()}
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def close(self) -> None:
        self._running = False
        try:
            self._srv.close()
        except OSError:
            pass
        self.drop_connections()
