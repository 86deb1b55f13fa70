"""RESP (REdis Serialization Protocol) — stdlib-only client + mini server.

The reference's control plane runs on Redis (client_redis.py, presence
keys, pub/sub topics). This environment has neither a redis server nor
the ``redis`` package, and the framework must not grow dependencies —
so the wire protocol lives here:

- :class:`RespClient` — a thread-safe RESP2 command client over a plain
  socket. Speaks to a real Redis in production deployments and to
  :class:`MiniRedisServer` in tests/dev. Raises ``ConnectionError`` on
  transport failure; callers own retry policy (the bus implements the
  reference's reconnect-requeue, client_redis.py:140-152).
- :class:`RespPubSub` — a dedicated subscriber connection with
  automatic reconnect + re-subscribe (the reference re-subscribes
  everything from a handler thread on reconnect, client_redis.py:74-92).
- :class:`MiniRedisServer` — a threaded in-process server implementing
  the subset the control plane uses (GET/SET-EX/DEL, sets, lists,
  KEYS, PUBLISH/(P)SUBSCRIBE). Used by the multi-host tests and by
  single-box deployments that don't want to operate a real Redis;
  ``drop_connections()`` simulates a broker outage for failover tests.

Only bytes/str/int travel on the wire; JSON encoding of event bodies
stays in ``control.bus``.
"""

from __future__ import annotations

import fnmatch
import logging
import socket
import threading
import time

log = logging.getLogger(__name__)


# --------------------------------------------------------------- wire
def encode_command(*args) -> bytes:
    """Encode a command as a RESP array of bulk strings."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, bytes):
            b = a
        elif isinstance(a, str):
            b = a.encode()
        else:
            b = str(a).encode()
        out.append(b"$%d\r\n%s\r\n" % (len(b), b))
    return b"".join(out)


class _Incomplete(Exception):
    """A full reply is not yet buffered; recv more and re-parse."""


_MAX_NEST = 32   # Redis itself never nests deeper than a few levels


def _parse_reply(buf: bytes, pos: int, depth: int = 0):
    """Parse one RESP reply starting at ``buf[pos:]``.

    Returns ``(value, newpos)``; raises :class:`_Incomplete` when more
    bytes are needed. Server errors (``-``) are *returned* as
    :class:`RespError` instances rather than raised so that an error
    nested inside an array still consumes its bytes. Nesting is capped
    at ``_MAX_NEST`` so a hostile peer streaming ``*1\\r\\n`` forever
    hits the ConnectionError contract, not RecursionError.
    """
    if depth > _MAX_NEST:
        raise ConnectionError("RESP nesting too deep")
    i = buf.find(b"\r\n", pos)
    if i < 0:
        raise _Incomplete
    line = buf[pos:i]
    pos = i + 2
    t, rest = line[:1], line[1:]
    # Malformed wire data (non-numeric lengths, absurd sizes, invalid
    # utf-8) is a protocol desync, surfaced as ConnectionError so the
    # callers' reconnect paths — not a stray ValueError — handle it
    # (tests/test_fuzz_robustness.py).
    if t == b"+":
        return rest.decode(errors="replace"), pos
    if t == b"-":
        return RespError(rest.decode(errors="replace")), pos
    if t == b":":
        try:
            return int(rest), pos
        except ValueError:
            raise ConnectionError(f"bad RESP integer {rest[:32]!r}")
    if t in (b"$", b"*"):
        try:
            n = int(rest)
        except ValueError:
            raise ConnectionError(f"bad RESP length {rest[:32]!r}")
        if n < -1 or n > (1 << 29):     # Redis caps bulks at 512 MB
            raise ConnectionError(f"unreasonable RESP length {n}")
        if n < 0:
            return None, pos
        if t == b"$":
            if len(buf) < pos + n + 2:
                raise _Incomplete
            return buf[pos:pos + n], pos + n + 2
        items = []
        for _ in range(n):
            v, pos = _parse_reply(buf, pos, depth + 1)
            items.append(v)
        return items, pos
    raise ConnectionError(f"bad RESP type byte {t!r}")


class _Reader:
    """Incremental RESP reply parser over a socket.

    ``read()`` is **resumable**: bytes are consumed from the buffer only
    once a complete reply has been parsed, so a ``socket.timeout`` that
    interrupts a reply fragmented across recv()s leaves the stream
    intact — the next call re-parses from the preserved prefix instead
    of desyncing (pubsub connections poll with a 0.5 s recv timeout).
    """

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = b""

    def _fill(self) -> None:
        chunk = self.sock.recv(65536)
        if not chunk:
            raise ConnectionError("peer closed")
        self.buf += chunk

    def read(self):
        """One reply: str (+simple), int (:), bytes ($bulk), None
        ($-1/*-1), list (*array); raises RespError on (-)."""
        while True:
            try:
                value, pos = _parse_reply(self.buf, 0)
            except _Incomplete:
                self._fill()
                continue
            self.buf = self.buf[pos:]
            if isinstance(value, RespError):
                raise value
            return value


class RespError(Exception):
    """Server-side -ERR reply."""


# -------------------------------------------------------------- client
class RespClient:
    """Thread-safe request/response RESP client (one in-flight command)."""

    def __init__(self, host: str = "localhost", port: int = 6379,
                 timeout: float = 5.0):
        self.host, self.port, self.timeout = host, port, timeout
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._reader: _Reader | None = None

    def _connect(self) -> None:
        s = socket.create_connection((self.host, self.port),
                                     timeout=self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock, self._reader = s, _Reader(s)

    def execute(self, *args):
        with self._lock:
            try:
                if self._sock is None:
                    self._connect()
                self._sock.sendall(encode_command(*args))
                return self._reader.read()
            except RespError:
                raise
            except (OSError, ConnectionError) as e:
                self._close_locked()
                raise ConnectionError(str(e)) from e

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self._reader = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    # convenience verbs (the subset the control plane uses)
    def ping(self) -> bool:
        return self.execute("PING") == "PONG"

    def publish(self, channel: str, data) -> int:
        return self.execute("PUBLISH", channel, data)

    def set(self, key: str, value, ex: int | None = None):
        if ex is None:
            return self.execute("SET", key, value)
        return self.execute("SET", key, value, "EX", ex)

    def get(self, key: str):
        return self.execute("GET", key)

    def delete(self, *keys: str) -> int:
        return self.execute("DEL", *keys)

    def sadd(self, key: str, *members) -> int:
        return self.execute("SADD", key, *members)

    def srem(self, key: str, *members) -> int:
        return self.execute("SREM", key, *members)

    def smembers(self, key: str) -> list[bytes]:
        return self.execute("SMEMBERS", key) or []

    def keys(self, pattern: str) -> list[bytes]:
        return self.execute("KEYS", pattern) or []

    def scan_iter(self, pattern: str, count: int = 100):
        """Cursor-based SCAN MATCH — non-blocking on a shared production
        Redis, unlike KEYS (O(total keyspace) under the server lock)."""
        cursor = b"0"
        while True:
            cursor, batch = self.execute(
                "SCAN", cursor, "MATCH", pattern, "COUNT", count)
            yield from batch
            if cursor in (b"0", 0, "0"):
                return

    def rpush(self, key: str, *values) -> int:
        return self.execute("RPUSH", key, *values)

    def lrange(self, key: str, start: int, stop: int) -> list[bytes]:
        return self.execute("LRANGE", key, start, stop) or []

    def llen(self, key: str) -> int:
        return self.execute("LLEN", key)


class RespPubSub:
    """Subscriber connection: psubscribe patterns, dispatch from a
    reader thread, reconnect + re-subscribe on failure."""

    def __init__(self, host: str = "localhost", port: int = 6379,
                 reconnect_s: float = 0.5):
        self.host, self.port = host, port
        self.reconnect_s = reconnect_s
        self._patterns: dict[str, list] = {}
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._running = True
        self.reconnects = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="resp-pubsub")
        self._thread.start()

    def psubscribe(self, pattern: str, callback) -> None:
        with self._lock:
            self._patterns.setdefault(pattern, []).append(callback)
            sock = self._sock
        if sock is not None:
            try:
                sock.sendall(encode_command("PSUBSCRIBE", pattern))
            except OSError:
                pass  # reader thread reconnects and re-subscribes

    def punsubscribe(self, pattern: str, callback=None) -> None:
        with self._lock:
            cbs = self._patterns.get(pattern, [])
            if callback is None:
                cbs = []
            else:
                cbs = [c for c in cbs if c is not callback]
            if cbs:
                self._patterns[pattern] = cbs
                return
            self._patterns.pop(pattern, None)
            sock = self._sock
        if sock is not None:
            try:
                sock.sendall(encode_command("PUNSUBSCRIBE", pattern))
            except OSError:
                pass

    def _run(self) -> None:
        first = True
        while self._running:
            try:
                s = socket.create_connection((self.host, self.port),
                                             timeout=5.0)
                s.settimeout(0.5)
                with self._lock:
                    self._sock = s
                    pats = list(self._patterns)
                if not first:
                    self.reconnects += 1
                first = False
                for p in pats:
                    s.sendall(encode_command("PSUBSCRIBE", p))
                reader = _Reader(s)
                while self._running:
                    try:
                        msg = reader.read()
                    except socket.timeout:
                        continue
                    if (isinstance(msg, list) and len(msg) == 4
                            and msg[0] == b"pmessage"):
                        pat = msg[1].decode()
                        chan = msg[2].decode()
                        with self._lock:
                            cbs = list(self._patterns.get(pat, []))
                        for cb in cbs:
                            try:
                                cb(chan, msg[3])
                            except Exception:
                                log.exception("pubsub callback error")
            except (OSError, ConnectionError):
                with self._lock:
                    self._sock = None
                if self._running:
                    time.sleep(self.reconnect_s)

    def close(self) -> None:
        self._running = False
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


# -------------------------------------------------------------- server
class MiniRedisServer:
    """Threaded RESP server for tests/dev: strings with EX expiry, sets,
    lists, KEYS, pub/sub with patterns. Single shared store + lock —
    the control plane's message rates are tiny (JSON events)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._store: dict[str, tuple] = {}   # key -> (kind, value, exp)
        self._lock = threading.RLock()
        self._subs: list[tuple] = []          # (conn, patterns set, lock)
        self._running = True
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(0.5)
        self.host, self.port = self._srv.getsockname()[:2]
        self._conns: list[socket.socket] = []
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="miniredis")
        self._thread.start()

    # ---- store helpers
    def _alive(self, key: str):
        ent = self._store.get(key)
        if ent is None:
            return None
        kind, value, exp = ent
        if exp is not None and time.monotonic() > exp:
            del self._store[key]
            return None
        return ent

    # ---- network
    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        reader = _Reader(conn)
        send_lock = threading.Lock()
        sub_entry = None
        try:
            while self._running:
                try:
                    cmd = reader.read()
                except (ConnectionError, OSError):
                    break
                if not isinstance(cmd, list) or not cmd:
                    break
                name = cmd[0].decode().upper()
                args = cmd[1:]
                if name in ("SUBSCRIBE", "PSUBSCRIBE"):
                    if sub_entry is None:
                        sub_entry = (conn, set(), send_lock)
                        with self._lock:
                            self._subs.append(sub_entry)
                    for i, pat in enumerate(args):
                        sub_entry[1].add(pat.decode())
                        kind = ("subscribe" if name == "SUBSCRIBE"
                                else "psubscribe")
                        with send_lock:
                            conn.sendall(_reply_array([
                                kind.encode(), pat, i + 1]))
                    continue
                if name in ("UNSUBSCRIBE", "PUNSUBSCRIBE"):
                    if sub_entry is not None:
                        for pat in args:
                            sub_entry[1].discard(pat.decode())
                    with send_lock:
                        conn.sendall(_reply_array(
                            [name.lower().encode(),
                             args[0] if args else None, 0]))
                    continue
                try:
                    reply = self._execute(name, args)
                except RespError as e:
                    reply = b"-ERR %s\r\n" % str(e).encode()
                with send_lock:
                    conn.sendall(reply)
        finally:
            if sub_entry is not None:
                with self._lock:
                    if sub_entry in self._subs:
                        self._subs.remove(sub_entry)
            try:
                conn.close()
            except OSError:
                pass

    def _execute(self, name: str, args: list[bytes]) -> bytes:
        with self._lock:
            if name == "PING":
                return b"+PONG\r\n"
            if name == "SET":
                key = args[0].decode()
                exp = None
                if len(args) >= 4 and args[2].decode().upper() == "EX":
                    exp = time.monotonic() + int(args[3])
                self._store[key] = ("str", args[1], exp)
                return b"+OK\r\n"
            if name == "GET":
                ent = self._alive(args[0].decode())
                if ent is None or ent[0] != "str":
                    return b"$-1\r\n"
                return _reply_bulk(ent[1])
            if name == "DEL":
                n = 0
                for a in args:
                    if self._store.pop(a.decode(), None) is not None:
                        n += 1
                return b":%d\r\n" % n
            if name == "EXPIRE":
                key = args[0].decode()
                ent = self._alive(key)
                if ent is None:
                    return b":0\r\n"
                self._store[key] = (ent[0], ent[1],
                                    time.monotonic() + int(args[1]))
                return b":1\r\n"
            if name == "SADD":
                key = args[0].decode()
                ent = self._alive(key)
                s = set(ent[1]) if ent and ent[0] == "set" else set()
                n = 0
                for m in args[1:]:
                    if m not in s:
                        s.add(m)
                        n += 1
                self._store[key] = ("set", s, None)
                return b":%d\r\n" % n
            if name == "SREM":
                ent = self._alive(args[0].decode())
                if ent is None or ent[0] != "set":
                    return b":0\r\n"
                n = 0
                for m in args[1:]:
                    if m in ent[1]:
                        ent[1].discard(m)
                        n += 1
                return b":%d\r\n" % n
            if name == "SMEMBERS":
                ent = self._alive(args[0].decode())
                if ent is None or ent[0] != "set":
                    return _reply_array([])
                return _reply_array(sorted(ent[1]))
            if name == "KEYS":
                pat = args[0].decode()
                keys = [k for k in list(self._store)
                        if self._alive(k) is not None
                        and fnmatch.fnmatchcase(k, pat)]
                return _reply_array([k.encode() for k in sorted(keys)])
            if name == "SCAN":
                # cursor = index into the sorted key list (stable enough
                # for a test server; real Redis uses bucket cursors)
                cursor = int(args[0])
                pat, count = "*", 10
                rest = [a.decode() for a in args[1:]]
                for j in range(0, len(rest) - 1, 2):
                    if rest[j].upper() == "MATCH":
                        pat = rest[j + 1]
                    elif rest[j].upper() == "COUNT":
                        count = int(rest[j + 1])
                live = sorted(k for k in list(self._store)
                              if self._alive(k) is not None)
                window = live[cursor:cursor + count]
                nxt = cursor + count
                nxt_b = b"0" if nxt >= len(live) else str(nxt).encode()
                hits = [k.encode() for k in window
                        if fnmatch.fnmatchcase(k, pat)]
                return (b"*2\r\n" + _reply_bulk(nxt_b) +
                        _reply_array(hits))
            if name == "RPUSH":
                key = args[0].decode()
                ent = self._alive(key)
                if ent is not None and ent[0] != "list":
                    raise RespError("WRONGTYPE Operation against a key "
                                    "holding the wrong kind of value")
                lst = list(ent[1]) if ent else []
                lst.extend(args[1:])
                self._store[key] = ("list", lst, None)
                return b":%d\r\n" % len(lst)
            if name == "LRANGE":
                ent = self._alive(args[0].decode())
                if ent is None or ent[0] != "list":
                    return _reply_array([])
                lst = ent[1]
                start, stop = int(args[1]), int(args[2])
                if stop == -1:
                    stop = len(lst) - 1
                return _reply_array(lst[start:stop + 1])
            if name == "LLEN":
                ent = self._alive(args[0].decode())
                n = len(ent[1]) if ent and ent[0] == "list" else 0
                return b":%d\r\n" % n
            if name == "PUBLISH":
                chan = args[0].decode()
                payload = args[1]
                subs = list(self._subs)
        # deliver outside the store lock
        if name == "PUBLISH":
            n = 0
            for conn, pats, slock in subs:
                for p in pats:
                    if p == chan or fnmatch.fnmatchcase(chan, p):
                        try:
                            with slock:
                                conn.sendall(_reply_array(
                                    [b"pmessage", p.encode(),
                                     chan.encode(), payload]))
                            n += 1
                        except OSError:
                            pass
                        break
            return b":%d\r\n" % n
        raise RespError(f"unknown command '{name}'")

    def drop_connections(self) -> None:
        """Simulate a broker bounce: kill every live client connection
        (the server keeps running; clients must reconnect)."""
        conns, self._conns = self._conns, []
        with self._lock:
            # purge subscriptions of the dropped conns immediately so
            # observers of _subs can't mistake a dead entry for a live
            # re-subscribe (the serve threads also remove on wake)
            self._subs = [s for s in self._subs if s[0] not in conns]
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


def _reply_bulk(b) -> bytes:
    if b is None:
        return b"$-1\r\n"
    if isinstance(b, int):
        return b":%d\r\n" % b
    if isinstance(b, str):
        b = b.encode()
    return b"$%d\r\n%s\r\n" % (len(b), b)


def _reply_array(items) -> bytes:
    out = [b"*%d\r\n" % len(items)]
    for it in items:
        out.append(_reply_bulk(it))
    return b"".join(out)
