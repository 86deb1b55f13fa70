"""Frontend control server + client: the reference's channelizer RPC
protocol, wire-compatible.

Server side replaces the ZMQ REP loop of ``rc_frontend/receiver.py``
(:503-700): a comma-delimited text protocol over REP —

    connect                       → connect,<client_id>
    create,<c>,<rate>,<freq>      → create,<block_id>,<port> | na,<freq>
    release,<c>,<block_id>        → release,<block_id> | na,<block_id>
    hb,<c>                        → hb,<c> | fail,<c>
    offset,<c>,<block_id>,<off>   → offset,<c>
    scan_mode_set_freq,<freq>     → success | fail
    quit,<c>                      → quit,<c>

Channel "creation" is slot allocation in the :class:`ChannelScheduler`
(no flowgraph is spawned — the batched pipeline already computes every
slot); the ``port`` field is repurposed as the slot index so existing
clients keep parsing the same two-field reply. A maintenance thread
reaps silent clients and idle slots and logs the reference's 10 s status
line (receiver.py:621-625).

Client side replaces ``frontend_connector.py``: REQ with 1 s timeouts,
reconnect-and-retry, 0.25 s heartbeat thread (frontend_connector.py:
41-96, 197-229).
"""

from __future__ import annotations

import logging
import threading
import time

log = logging.getLogger(__name__)


class FrontendServer:
    """ZMQ REP server around a ChannelScheduler."""

    def __init__(self, scheduler, bind: str = "tcp://0.0.0.0:0",
                 on_scan_set_freq=None):
        import zmq
        self.scheduler = scheduler
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.REP)
        if bind.endswith(":0"):
            self.port = self.sock.bind_to_random_port("tcp://0.0.0.0")
        else:
            self.sock.bind(bind)
            # bind() returns None; recover the port from the resolved
            # endpoint so explicit binds still advertise correctly.
            last = self.sock.getsockopt_string(zmq.LAST_ENDPOINT)
            self.port = int(last.rsplit(":", 1)[1])
        self.on_scan_set_freq = on_scan_set_freq
        self._client_num = 0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.start_time = time.time()

    # -- protocol ------------------------------------------------------
    def handle(self, msg: str) -> str:
        """Pure protocol handler (tested without sockets)."""
        data = msg.strip().split(",")
        sched = self.scheduler
        verb = data[0]
        if verb == "connect":
            c = self._client_num
            self._client_num += 1
            sched.connect(str(c))
            log.info("connect received from %s", c)
            return "connect,%s" % c
        if verb == "create":
            c, rate, freq = data[1], int(data[2]), int(data[3])
            got = sched.create_channel(c, rate, freq)
            if got is None:
                log.error("failed to create channel %s", freq)
                return "na,%s" % freq
            _src, slot, block_id = got
            return "create,%s,%s" % (block_id, slot)
        if verb == "release":
            c, block_id = data[1], int(data[2])
            if sched.release_channel(c, block_id):
                return "release,%s" % block_id
            return "na,%s" % block_id
        if verb == "hb":
            c = data[1]
            return ("hb,%s" if sched.heartbeat(c) else "fail,%s") % c
        if verb == "offset":
            c, block_id, off = data[1], int(data[2]), float(data[3])
            loc = sched.slot_of(block_id)
            if loc is not None:
                sched.report_offset(loc[0], off)
            return "offset,%s" % c
        if verb == "scan_mode_set_freq":
            freq = int(data[1])
            try:
                if self.on_scan_set_freq is not None:
                    self.on_scan_set_freq(freq)
                else:
                    next(iter(self.scheduler.sources.values())
                         ).center_freq = freq
                return "success"
            except Exception:
                return "fail"
        if verb == "quit":
            c = data[1]
            sched.quit(c)
            return "quit,%s" % c
        return "na"

    # -- lifecycle ------------------------------------------------------
    def serve_forever(self, poll_ms: int = 1) -> None:
        import zmq
        last_status = time.time()
        while not self._stop.is_set():
            if self.sock.poll(poll_ms):
                msg = self.sock.recv_string()
                try:
                    reply = self.handle(msg)
                except Exception as e:      # never wedge the REP state
                    log.error("handler error on %r: %s", msg, e)
                    reply = "na"
                self.sock.send_string(reply or "na")
            self.scheduler.reap()
            if time.time() - last_status > 10:
                st = self.scheduler.stats()
                log.info("Frontend Status: clients: %s channels: %s "
                         "uptime: %s", st["clients"], st["active"],
                         int(time.time() - self.start_time))
                last_status = time.time()

    def start(self) -> "FrontendServer":
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self.sock.close(0)


class FrontendConnector:
    """REQ client of the protocol above (frontend_connector.py API:
    create_channel/release_channel/report_offset plus auto-heartbeat)."""

    HB_PERIOD_S = 0.25        # frontend_connector.py:220
    TIMEOUT_MS = 1000         # frontend_connector.py:41-60

    def __init__(self, endpoint: str, heartbeat: bool = True):
        import zmq
        self._zmq = zmq
        self.endpoint = endpoint
        self.ctx = zmq.Context.instance()
        self._lock = threading.RLock()
        self._connect_socket()
        self.client_id = self._rpc("connect").split(",")[1]
        self._stop = threading.Event()
        self._hb_thread = None
        self.my_channels: dict[int, tuple[float, float]] = {}
        if heartbeat:
            self._hb_thread = threading.Thread(target=self._hb_loop,
                                               daemon=True)
            self._hb_thread.start()

    def _connect_socket(self):
        zmq = self._zmq
        self.sock = self.ctx.socket(zmq.REQ)
        self.sock.setsockopt(zmq.LINGER, 0)
        self.sock.setsockopt(zmq.RCVTIMEO, self.TIMEOUT_MS)
        self.sock.setsockopt(zmq.SNDTIMEO, self.TIMEOUT_MS)
        self.sock.connect(self.endpoint)

    def _rpc(self, msg: str) -> str:
        with self._lock:
            try:
                self.sock.send_string(msg)
                return self.sock.recv_string()
            except self._zmq.Again:
                # REQ is now wedged; rebuild the socket
                # (frontend_connector.py:212-216 teardown + reconnect).
                self.sock.close(0)
                self._connect_socket()
                raise TimeoutError("frontend rpc timeout: %s" % msg)

    def create_channel(self, rate: float, freq: float
                       ) -> tuple[int, int] | None:
        """→ (block_id, slot) or None (frontend_connector.py:127-160)."""
        r = self._rpc("create,%s,%d,%d" % (self.client_id, rate, freq))
        parts = r.split(",")
        if parts[0] != "create":
            return None
        block_id, slot = int(parts[1]), int(parts[2])
        self.my_channels[block_id] = (rate, freq)
        return block_id, slot

    def release_channel(self, block_id: int) -> bool:
        r = self._rpc("release,%s,%s" % (self.client_id, block_id))
        self.my_channels.pop(block_id, None)
        return r.split(",")[0] == "release"

    def report_offset(self, block_id: int, offset_hz: float) -> bool:
        r = self._rpc("offset,%s,%s,%s" % (self.client_id, block_id,
                                           offset_hz))
        return r.split(",")[0] == "offset"

    def scan_mode_set_freq(self, freq: float) -> bool:
        return self._rpc("scan_mode_set_freq,%d" % freq) == "success"

    def quit(self) -> None:
        self._stop.set()
        try:
            self._rpc("quit,%s" % self.client_id)
        except TimeoutError:
            pass

    def _hb_loop(self) -> None:
        while not self._stop.is_set():
            try:
                r = self._rpc("hb,%s" % self.client_id)
                if r.split(",")[0] == "fail":
                    # Server reaped us: reconnect + re-create channels
                    # (frontend_connector.py:212-216).
                    self.client_id = self._rpc("connect").split(",")[1]
                    for bid, (rate, freq) in list(self.my_channels.items()):
                        self.my_channels.pop(bid)
                        self.create_channel(rate, freq)
            except TimeoutError:
                pass
            self._stop.wait(self.HB_PERIOD_S)
