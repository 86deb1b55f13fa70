"""rtl_tcp streaming client: the live-SDR producer for ``IngestRing``.

The reference opens RTL-SDR dongles in-process through gr-osmosdr
(rc_frontend/receiver.py:170-204: ``osmosdr.source('rtl=N')`` with
sample rate, center frequency, per-dongle ppm correction, and gain
settings).  The TPU deployment keeps dongles on whatever host has the
USB bus and streams them over the standard **rtl_tcp** protocol — one
``rtl_tcp`` daemon per dongle (deploy/rtl-tcp@.service, the analog of
the reference's ``radiocapture-channelizer@.service`` template) — into
the native ingest ring on the capture host.

Protocol (rtl_tcp, public): on connect the server sends a 12-byte
header — magic ``"RTL0"``, tuner type (u32 BE), tuner gain count
(u32 BE) — then an endless stream of interleaved uint8 I/Q pairs
(127.5 offset).  The client configures the dongle with 5-byte commands
``cmd(u8) | value(u32 BE)``:

    0x01 set center frequency (Hz)      0x02 set sample rate (Hz)
    0x03 set gain mode (1=manual)       0x04 set tuner gain (0.1 dB)
    0x05 set freq correction (ppm)      0x08 set AGC mode

:class:`RtlTcpSource` owns a reader thread that pushes the cu8 stream
straight into an :class:`~radiocapture_tpu_torch.frontend.ingest.IngestRing`
(the native pop converts to float32 re/im, ingest.cc FMT_CU8) and
reconnects with backoff on failure — the everything-heartbeats liveness
stance of SURVEY.md §5.3.  AFC retunes reuse ``set_center_freq`` like
the reference's ``source_offset`` path (rc_frontend/receiver.py:436-475).
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time

import numpy as np

from radiocapture_tpu_torch.frontend.ingest import IngestRing

log = logging.getLogger(__name__)

MAGIC = b"RTL0"

CMD_SET_FREQ = 0x01
CMD_SET_SAMP_RATE = 0x02
CMD_SET_GAIN_MODE = 0x03
CMD_SET_GAIN = 0x04
CMD_SET_FREQ_CORRECTION = 0x05
CMD_SET_AGC_MODE = 0x08

DEFAULT_PORT = 1234


def pack_cmd(cmd: int, value: int) -> bytes:
    return struct.pack(">BI", cmd, int(value) & 0xFFFFFFFF)


def parse_addr(args: str, index: int = 0) -> tuple[str, int]:
    """Source address from a config ``args`` string.

    Accepts ``rtl_tcp=host:port``, ``host:port``, ``host`` (default
    port), or the reference's local form ``rtl=N`` / empty (localhost,
    port 1234+N — the conventional per-dongle rtl_tcp port layout)."""
    a = (args or "").strip()
    if a.startswith("rtl_tcp="):
        a = a[len("rtl_tcp="):]
    if a.startswith("rtl="):
        return "127.0.0.1", DEFAULT_PORT + int(a[4:] or 0)
    if not a:
        return "127.0.0.1", DEFAULT_PORT + index
    if ":" in a:
        host, port = a.rsplit(":", 1)
        return host, int(port)
    return a, DEFAULT_PORT


class RtlTcpSource:
    """One dongle's rtl_tcp stream → ingest ring, with auto-reconfigure
    on (re)connect and reconnect-with-backoff."""

    def __init__(self, host: str, port: int, samp_rate: float,
                 center_freq: float, ppm: int = 0,
                 gain_tenth_db: int | None = None,
                 ring: IngestRing | None = None,
                 capacity_samples: int = 1 << 22,
                 reconnect_s: float = 1.0,
                 connect_timeout_s: float = 5.0):
        self.host, self.port = host, port
        self.samp_rate = int(samp_rate)
        self.center_freq = int(center_freq)
        self.ppm = int(ppm)
        self.gain_tenth_db = gain_tenth_db
        self.ring = ring or IngestRing("cu8",
                                       capacity_samples=capacity_samples)
        self.reconnect_s = reconnect_s
        self.connect_timeout_s = connect_timeout_s
        self.tuner_type: int | None = None
        self.tuner_gain_count: int | None = None
        self.connects = 0
        self.bytes_in = 0
        self._sock: socket.socket | None = None
        self._running = True
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"rtl-tcp-{host}:{port}")
        self._thread.start()

    # ---- control (reference receiver verbs) ----
    def set_center_freq(self, freq_hz: float) -> None:
        """Retune — the AFC verb (rc_frontend/receiver.py:436-475)."""
        self.center_freq = int(freq_hz)
        self._send(pack_cmd(CMD_SET_FREQ, self.center_freq))

    def _send(self, data: bytes) -> None:
        with self._lock:
            s = self._sock
        if s is not None:
            try:
                s.sendall(data)
            except OSError:
                pass     # reader thread reconnects and re-configures

    def _configure(self, s: socket.socket) -> None:
        s.sendall(pack_cmd(CMD_SET_SAMP_RATE, self.samp_rate))
        s.sendall(pack_cmd(CMD_SET_FREQ, self.center_freq))
        if self.ppm:
            s.sendall(pack_cmd(CMD_SET_FREQ_CORRECTION, self.ppm))
        if self.gain_tenth_db is None:
            s.sendall(pack_cmd(CMD_SET_GAIN_MODE, 0))   # auto
            s.sendall(pack_cmd(CMD_SET_AGC_MODE, 1))
        else:
            s.sendall(pack_cmd(CMD_SET_GAIN_MODE, 1))
            s.sendall(pack_cmd(CMD_SET_GAIN, self.gain_tenth_db))

    # ---- reader ----
    def _run(self) -> None:
        stale = b""
        while self._running:
            try:
                s = socket.create_connection(
                    (self.host, self.port),
                    timeout=self.connect_timeout_s)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.settimeout(1.0)
                hdr = b""
                while len(hdr) < 12:
                    chunk = s.recv(12 - len(hdr))
                    if not chunk:
                        raise ConnectionError("closed in header")
                    hdr += chunk
                if hdr[:4] != MAGIC:
                    raise ConnectionError(
                        f"not an rtl_tcp server: {hdr[:4]!r}")
                self.tuner_type = struct.unpack(">I", hdr[4:8])[0]
                self.tuner_gain_count = struct.unpack(">I", hdr[8:12])[0]
                self._configure(s)
                with self._lock:
                    self._sock = s
                self.connects += 1
                stale = b""
                while self._running:
                    try:
                        data = s.recv(262144)
                    except socket.timeout:
                        continue
                    if not data:
                        raise ConnectionError("stream closed")
                    self.bytes_in += len(data)
                    buf = stale + data
                    usable = len(buf) & ~1     # whole I/Q pairs
                    stale = buf[usable:]
                    if usable:
                        self.ring.push(
                            np.frombuffer(buf[:usable], np.uint8))
            except (OSError, ConnectionError) as e:
                with self._lock:
                    self._sock = None
                if self._running:
                    log.warning("rtl_tcp %s:%s: %s; reconnecting",
                                self.host, self.port, e)
                    time.sleep(self.reconnect_s)

    def provider(self, strict: bool = False, bf16: bool = False):
        """SiteRuntime block provider (zero-fills through dropouts by
        default — live capture keeps real-time cadence). ``bf16``
        delivers blocks in the TPU compute dtype (IngestRing.pop_bf16:
        lossless for the cu8 wire format)."""
        return self.ring.provider(strict=strict, bf16=bf16)

    def stop(self) -> None:
        self._running = False
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
        self._thread.join(timeout=2.0)


def source_for_config(src, index: int = 0) -> RtlTcpSource:
    """Build the streaming source for a ``SourceConfig`` with
    ``type == 'rtlsdr'`` (gain dict: first value in dB → tenths)."""
    host, port = parse_addr(getattr(src, "args", ""), index)
    gains = getattr(src, "gains", None) or {}
    gain = None
    for v in gains.values():
        gain = int(round(float(v) * 10))
        break
    return RtlTcpSource(host, port,
                        samp_rate=src.samp_rate,
                        center_freq=src.center_freq,
                        ppm=int(getattr(src, "offset", 0) or 0),
                        gain_tenth_db=gain)


class FakeRtlTcpServer:
    """In-test rtl_tcp daemon: speaks the real wire protocol and streams
    a repeating cu8 capture, recording the commands it receives."""

    def __init__(self, iq: np.ndarray, samp_rate: float = 2.4e6,
                 tuner_type: int = 5, gain_count: int = 29,
                 host: str = "127.0.0.1", chunk: int = 65536,
                 realtime: bool = False):
        """iq: complex64 array converted to cu8 on the wire."""
        x = np.asarray(iq)
        if np.iscomplexobj(x):
            cu = np.empty((len(x), 2), np.uint8)
            cu[:, 0] = np.clip(np.round(x.real * 127.5 + 127.5), 0, 255)
            cu[:, 1] = np.clip(np.round(x.imag * 127.5 + 127.5), 0, 255)
            self.payload = cu.reshape(-1).tobytes()
        else:
            self.payload = np.asarray(x, np.uint8).tobytes()
        self.samp_rate = samp_rate
        self.tuner_type = tuner_type
        self.gain_count = gain_count
        self.chunk = chunk
        self.realtime = realtime
        self.commands: list[tuple[int, int]] = []
        self._srv = socket.create_server((host, 0))
        self._srv.settimeout(0.25)
        self.host, self.port = self._srv.getsockname()[:2]
        self._running = True
        self._conns: list[socket.socket] = []
        self._thread = threading.Thread(target=self._accept,
                                        daemon=True, name="fake-rtltcp")
        self._thread.start()

    def _accept(self) -> None:
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            conn.sendall(MAGIC + struct.pack(">II", self.tuner_type,
                                             self.gain_count))
            conn.settimeout(0.0)
            pos = 0
            while self._running:
                try:
                    cmd = conn.recv(5)
                    while len(cmd) >= 5:
                        self.commands.append(
                            (cmd[0], struct.unpack(">I", cmd[1:5])[0]))
                        cmd = cmd[5:]
                except (BlockingIOError, socket.timeout):
                    pass
                end = min(pos + self.chunk, len(self.payload))
                conn.sendall(self.payload[pos:end])
                pos = end % len(self.payload)
                if self.realtime:
                    time.sleep(self.chunk / 2.0 / self.samp_rate)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def drop_connections(self) -> None:
        conns, self._conns = self._conns, []
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
