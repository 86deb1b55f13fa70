"""rciq: the driver-host IQ transport for USRP / bladeRF sources.

The reference opens USRPs and bladeRFs in-process through UHD /
gr-osmosdr (rc_frontend/receiver.py:88-169). TPU capture hosts have no
USB/PCIe SDR bus, so those radios live on a **driver host** — any box
that can run UHD or SoapySDR — and stream to the capture host over a
deliberately tiny TCP protocol, the ≥12-bit analog of the rtl_tcp path
(`frontend/rtl_tcp.py`; rtl_tcp itself only carries 8-bit samples):

- On connect the server sends a 24-byte header: magic ``RCIQ``,
  version (u8), wire format (u8: 0=cf32, 1=cs16), flags (u16, 0),
  sample rate (f64 BE), center frequency (f64 BE).
- The server then streams interleaved little-endian I/Q samples
  (float32 pairs for cf32, int16 pairs for cs16 — UHD's ``fc32`` /
  ``sc16`` CPU formats verbatim, so the driver host does no
  conversion).
- The client may send newline-delimited JSON commands at any time:
  ``{"cmd": "tune", "hz": f}`` (AFC retune, the reference's
  ``source_offset`` verb, receiver.py:436-475), ``{"cmd": "rate",
  "hz": f}``, ``{"cmd": "gain", "db": f, "name": "RF"}``.

:class:`RcIqSource` is the capture-host client: a reader thread pushes
the stream into the native :class:`IngestRing` (cs16 is normalized by
1/32768 in ingest.cc, matching UHD full scale) and reconnects with
backoff, re-sending its configuration — the same discipline as
:class:`~radiocapture_tpu_torch.frontend.rtl_tcp.RtlTcpSource`.
:class:`RcIqServer` is the driver-host side, reused both by
``tools/driver_host_sender.py`` (the UHD/SoapySDR reference sender)
and by the fake-driver-host e2e test (tests/test_rciq.py).
"""

from __future__ import annotations

import json
import logging
import socket
import struct
import threading
import time

import numpy as np

from radiocapture_tpu_torch.frontend.ingest import IngestRing

log = logging.getLogger(__name__)

MAGIC = b"RCIQ"
VERSION = 1
FMT_CODES = {"cf32": 0, "cs16": 1}
FMT_NAMES = {v: k for k, v in FMT_CODES.items()}
_BYTES_PER_SAMPLE = {"cf32": 8, "cs16": 4}
DEFAULT_PORT = 41234

_HDR = struct.Struct(">4sBBHdd")      # magic, ver, fmt, flags, rate, freq


def pack_header(fmt: str, samp_rate: float, center_freq: float) -> bytes:
    return _HDR.pack(MAGIC, VERSION, FMT_CODES[fmt], 0,
                     float(samp_rate), float(center_freq))


def parse_args(args: str, index: int = 0) -> tuple[str, int, str]:
    """(host, port, fmt) from a config ``args`` string: ``rciq=host:port``
    optionally with ``,fmt=cf32|cs16`` (default cs16), or bare
    ``host[:port]``; empty → localhost, port 41234+index."""
    a = (args or "").strip()
    fmt = "cs16"
    parts = [p for p in a.split(",") if p]
    addr = ""
    for p in parts:
        if p.startswith("fmt="):
            fmt = p[4:]
        elif p.startswith("rciq="):
            addr = p[5:]
        elif "=" not in p:
            addr = p
    if fmt not in FMT_CODES:
        raise ValueError(f"unknown rciq wire format {fmt!r}")
    if not addr:
        return "127.0.0.1", DEFAULT_PORT + index, fmt
    if ":" in addr:
        host, port = addr.rsplit(":", 1)
        return host, int(port), fmt
    return addr, DEFAULT_PORT, fmt


class RcIqSource:
    """One driver-host stream → ingest ring, with auto-reconfigure on
    (re)connect and reconnect-with-backoff (rtl_tcp discipline)."""

    def __init__(self, host: str, port: int, samp_rate: float,
                 center_freq: float, fmt: str = "cs16",
                 gains: dict | None = None,
                 ring: IngestRing | None = None,
                 capacity_samples: int = 1 << 22,
                 reconnect_s: float = 1.0,
                 connect_timeout_s: float = 5.0):
        if fmt not in FMT_CODES:
            raise ValueError(f"unknown rciq wire format {fmt!r}")
        self.host, self.port, self.fmt = host, port, fmt
        self.samp_rate = float(samp_rate)
        self.center_freq = float(center_freq)
        self.gains = dict(gains or {})
        self.ring = ring or IngestRing(fmt,
                                       capacity_samples=capacity_samples)
        self.reconnect_s = reconnect_s
        self.connect_timeout_s = connect_timeout_s
        self.server_rate: float | None = None
        self.server_freq: float | None = None
        self.connects = 0
        self.bytes_in = 0
        self._sock: socket.socket | None = None
        self._running = True
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"rciq-{host}:{port}")
        self._thread.start()

    # ---- control verbs ----
    def set_center_freq(self, freq_hz: float) -> None:
        """AFC retune (rc_frontend/receiver.py:436-475)."""
        self.center_freq = float(freq_hz)
        self._send_cmd({"cmd": "tune", "hz": self.center_freq})

    def _send_cmd(self, obj: dict) -> None:
        with self._lock:
            s = self._sock
        if s is not None:
            try:
                s.sendall(json.dumps(obj).encode() + b"\n")
            except OSError:
                pass     # reader thread reconnects and re-configures

    def _configure(self, s: socket.socket) -> None:
        cmds = [{"cmd": "rate", "hz": self.samp_rate},
                {"cmd": "tune", "hz": self.center_freq}]
        cmds += [{"cmd": "gain", "db": float(v), "name": str(k)}
                 for k, v in self.gains.items()]
        s.sendall(b"".join(json.dumps(c).encode() + b"\n" for c in cmds))

    # ---- reader ----
    def _run(self) -> None:
        bps = _BYTES_PER_SAMPLE[self.fmt]
        while self._running:
            try:
                s = socket.create_connection(
                    (self.host, self.port),
                    timeout=self.connect_timeout_s)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.settimeout(1.0)
                hdr = b""
                while len(hdr) < _HDR.size:
                    chunk = s.recv(_HDR.size - len(hdr))
                    if not chunk:
                        raise ConnectionError("closed in header")
                    hdr += chunk
                magic, ver, fmt_code, _flags, rate, freq = \
                    _HDR.unpack(hdr)
                if magic != MAGIC or ver != VERSION:
                    raise ConnectionError(
                        f"not an rciq v{VERSION} server: {hdr[:6]!r}")
                if FMT_NAMES.get(fmt_code) != self.fmt:
                    raise ConnectionError(
                        f"server streams {FMT_NAMES.get(fmt_code)!r}, "
                        f"client ring is {self.fmt!r}")
                self.server_rate, self.server_freq = rate, freq
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
                    usable = len(buf) - (len(buf) % bps)
                    stale = buf[usable:]
                    if usable:
                        wire = np.frombuffer(
                            buf[:usable],
                            np.complex64 if self.fmt == "cf32"
                            else np.int16)
                        self.ring.push(wire)
            except (OSError, ConnectionError) as e:
                with self._lock:
                    self._sock = None
                if self._running:
                    log.warning("rciq %s:%s: %s; reconnecting",
                                self.host, self.port, e)
                    time.sleep(self.reconnect_s)

    def provider(self, strict: bool = False, bf16=False):
        """SiteRuntime block provider (zero-fills through dropouts).
        ``bf16='auto'`` stays float32 here — cs16/cf32 exceed bf16's
        8-bit mantissa (frontend/ingest.py)."""
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


def source_for_config(src, index: int = 0) -> RcIqSource:
    """Build the streaming source for a ``SourceConfig`` with ``type``
    in {usrp, usrp2x, bladerf}. One stream per SourceConfig — a 2-ch
    USRP (the reference's usrp2x, receiver.py:110-145) is two configs
    pointing at two driver-host ports."""
    host, port, fmt = parse_args(getattr(src, "args", ""), index)
    return RcIqSource(host, port,
                      samp_rate=src.samp_rate,
                      center_freq=src.center_freq,
                      fmt=fmt, gains=getattr(src, "gains", None))


class RcIqServer:
    """Driver-host side: header + broadcast stream + JSON command intake.

    ``tools/driver_host_sender.py`` pairs it with a UHD/SoapySDR read
    loop; tests pair it with a replayed capture. ``on_command`` (if
    given) is called with each decoded command dict — the sender script
    uses it to retune the actual hardware."""

    def __init__(self, samp_rate: float, center_freq: float,
                 fmt: str = "cs16", host: str = "127.0.0.1",
                 port: int = 0, on_command=None):
        if fmt not in FMT_CODES:
            raise ValueError(f"unknown rciq wire format {fmt!r}")
        self.samp_rate = float(samp_rate)
        self.center_freq = float(center_freq)
        self.fmt = fmt
        self.on_command = on_command
        self.commands: list[dict] = []
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(0.25)
        self.host, self.port = self._srv.getsockname()[:2]
        self._running = True
        self._conns: list[socket.socket] = []
        self._cmd_buf: dict[socket.socket, bytes] = {}
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._accept,
                                        daemon=True, name="rciq-server")
        self._thread.start()

    def _accept(self) -> None:
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                conn.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
                # blocking sends with a deadline: a client that stalls
                # past it is dropped whole — a non-blocking partial
                # send could split an I/Q pair and desync the stream
                conn.settimeout(2.0)
                conn.sendall(pack_header(self.fmt, self.samp_rate,
                                         self.center_freq))
            except OSError:
                continue
            with self._lock:
                self._conns.append(conn)

    def to_wire(self, iq: np.ndarray) -> bytes:
        """complex64 (or already-wire-format) samples → wire bytes."""
        x = np.asarray(iq)
        if np.iscomplexobj(x):
            if self.fmt == "cf32":
                return np.ascontiguousarray(
                    x.astype(np.complex64)).tobytes()
            w = np.empty((len(x), 2), np.int16)
            w[:, 0] = np.clip(np.round(x.real * 32767.0), -32768, 32767)
            w[:, 1] = np.clip(np.round(x.imag * 32767.0), -32768, 32767)
            return w.tobytes()
        return np.ascontiguousarray(x).tobytes()

    def broadcast(self, iq: np.ndarray) -> None:
        """Send one block to every connected client, draining any
        pending command lines first. Dead clients are dropped."""
        data = self.to_wire(iq)
        with self._lock:
            conns = list(self._conns)
        import select
        for conn in conns:
            try:
                while True:
                    r, _, _ = select.select([conn], [], [], 0)
                    if not r:
                        break
                    cmd = conn.recv(4096)
                    if not cmd:
                        raise ConnectionError("client closed")
                    buf = self._cmd_buf.get(conn, b"") + cmd
                    # commands are newline-delimited; keep an unfinished
                    # tail for the next drain (TCP may fragment lines)
                    *lines, tail = buf.split(b"\n")
                    self._cmd_buf[conn] = tail
                    for line in lines:
                        if not line.strip():
                            continue
                        try:
                            obj = json.loads(line)
                        except ValueError:
                            continue
                        # a hostile/buggy capture host must not take
                        # down the radio feed for every other client:
                        # malformed commands (non-dict JSON, bad hz,
                        # on_command hardware errors) are logged and
                        # dropped, same stance as the RESP/STOMP
                        # parsers (tests/test_fuzz_robustness.py)
                        try:
                            self.commands.append(obj)
                            if obj.get("cmd") == "tune":
                                self.center_freq = float(obj.get(
                                    "hz", self.center_freq))
                            if self.on_command is not None:
                                self.on_command(obj)
                        except Exception:
                            log.warning("bad rciq command %r dropped",
                                        obj, exc_info=True)
                conn.sendall(data)
            except (OSError, ConnectionError):
                with self._lock:
                    if conn in self._conns:
                        self._conns.remove(conn)
                self._cmd_buf.pop(conn, None)
                try:
                    conn.close()
                except OSError:
                    pass

    @property
    def clients(self) -> int:
        with self._lock:
            return len(self._conns)

    def drop_connections(self) -> None:
        with self._lock:
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
