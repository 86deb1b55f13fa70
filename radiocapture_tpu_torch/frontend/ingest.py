"""IQ ingest: ctypes binding to the native C++ ring-buffer runtime.

The reference moves IQ between the SDR driver and consumers through C++
transports — gr-osmosdr/UHD callbacks, ``zeromq.pub_sink`` fan-out
(rc_frontend/receiver.py:201-202), and the legacy ``blocks.udp_source``
(receiver.py:91-92). Here the native library (native/ingest/ingest.cc)
owns that sample path: producers (an SDR driver thread, a UDP feed, or a
replay thread) push compact wire-format IQ (int8/int16/float32) into a
lock-free ring; :class:`IngestRing` pops fixed-size blocks converted to
the float32 re/im layout the TPU pipelines take, so the Python loop
never touches per-sample data. Overflow drops the incoming excess (the
SDR must never block, and the producer never mutates the consumer
cursor, so pops can't tear) and is counted, mirroring a full kernel
socket buffer dropping the newest datagrams.

Use as a :class:`radiocapture_tpu_torch.runtime.SiteRuntime` provider::

    ring = IngestRing("cs16", capacity_samples=2**22)
    udp = UdpFeed(ring, port=40000)           # or push from a driver
    rt = SiteRuntime(cfg, {0: ring.provider(strict=False)})
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger(__name__)

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_REPO_ROOT, "radiocapture_tpu_torch", "_build",
                         "native", "librcingest.so")
_lock = threading.Lock()
_lib = None

FORMATS = {"cf32": 0, "cs16": 1, "cs8": 2, "cu8": 3}
# Wire formats for which the bf16 pop is bit-lossless (sample has ≤8
# significant bits; bf16 mantissa is 8 bits).
_BF16_LOSSLESS = {"cu8", "cs8"}


def build_library(force: bool = False) -> str:
    """Compile native/ingest into librcingest.so under the package's
    ``_build/`` (idempotent). The compiler writes a name of this process's
    own and ``os.replace`` moves it into place, so a concurrent loader
    opens either the old library or the whole new one."""
    src = os.path.join(_NATIVE_DIR, "ingest", "ingest.cc")
    if force or not os.path.exists(_LIB_PATH) or \
            os.path.getmtime(_LIB_PATH) < os.path.getmtime(src):
        os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
        tmp = f"{_LIB_PATH}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-shared", "-o", tmp, src],
                check=True, cwd=_NATIVE_DIR, capture_output=True)
            os.replace(tmp, _LIB_PATH)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return _LIB_PATH


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            lib.rc_ring_create.restype = ctypes.c_void_p
            lib.rc_ring_create.argtypes = [ctypes.c_int32,
                                           ctypes.c_int64,
                                           ctypes.c_float]
            lib.rc_ring_destroy.argtypes = [ctypes.c_void_p]
            lib.rc_ring_available.restype = ctypes.c_int64
            lib.rc_ring_available.argtypes = [ctypes.c_void_p]
            lib.rc_ring_dropped.restype = ctypes.c_int64
            lib.rc_ring_dropped.argtypes = [ctypes.c_void_p]
            lib.rc_ring_push.restype = ctypes.c_int64
            lib.rc_ring_push.argtypes = [ctypes.c_void_p,
                                         ctypes.c_void_p,
                                         ctypes.c_int64]
            lib.rc_ring_pop_f32.restype = ctypes.c_int64
            lib.rc_ring_pop_f32.argtypes = [ctypes.c_void_p,
                                            ctypes.c_void_p,
                                            ctypes.c_int64]
            lib.rc_ring_pop_bf16.restype = ctypes.c_int64
            lib.rc_ring_pop_bf16.argtypes = [ctypes.c_void_p,
                                             ctypes.c_void_p,
                                             ctypes.c_int64]
            lib.rc_udp_open.restype = ctypes.c_void_p
            lib.rc_udp_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_int]
            lib.rc_udp_pump.restype = ctypes.c_int64
            lib.rc_udp_pump.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int64]
            lib.rc_udp_stop.argtypes = [ctypes.c_void_p]
            lib.rc_udp_close.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


_WIRE_DTYPE = {"cf32": np.complex64, "cs16": np.int16, "cs8": np.int8,
               "cu8": np.uint8}


class IngestRing:
    """Lock-free SPSC IQ ring in the native library."""

    def __init__(self, fmt: str = "cs16",
                 capacity_samples: int = 1 << 22, scale: float = 1.0):
        if fmt not in FORMATS:
            raise ValueError(f"unknown wire format {fmt!r}")
        self.fmt = fmt
        self._lib = _load()
        self._h = self._lib.rc_ring_create(FORMATS[fmt],
                                           capacity_samples, scale)
        if not self._h:
            raise MemoryError("ring allocation failed")

    def push(self, samples: np.ndarray) -> int:
        """Producer side: wire-format samples — complex64 for 'cf32',
        interleaved int16/int8/uint8 pairs (or [n, 2]) otherwise.
        Returns samples accepted; the overflow remainder is dropped and
        counted in :attr:`dropped`."""
        a = np.ascontiguousarray(samples)
        if self.fmt == "cf32":
            n = a.size if a.dtype == np.complex64 else a.size // 2
        else:
            n = a.size // 2
        return self._lib.rc_ring_push(
            self._h, a.ctypes.data_as(ctypes.c_void_p), n)

    def pop(self, n: int) -> np.ndarray | None:
        """Consumer side: [n, 2] float32 re/im, or None if under-filled."""
        out = np.empty((n, 2), np.float32)
        got = self._lib.rc_ring_pop_f32(
            self._h, out.ctypes.data_as(ctypes.c_void_p), n)
        return out if got == n else None

    def pop_bf16(self, n: int) -> np.ndarray | None:
        """Consumer side: [n, 2] bfloat16 re/im as their uint16 bit
        patterns (numpy has no bfloat16; ``device.wire_from_numpy`` views
        them as ``torch.bfloat16``), or None if under-filled. Lossless for
        cu8/cs8 wire formats (8 significant bits vs bf16's 8-bit mantissa)
        and half the float32 host → device stream."""
        out = np.empty((n, 2), np.uint16)
        got = self._lib.rc_ring_pop_bf16(
            self._h, out.ctypes.data_as(ctypes.c_void_p), n)
        return out if got == n else None

    @property
    def available(self) -> int:
        return self._lib.rc_ring_available(self._h)

    @property
    def dropped(self) -> int:
        return self._lib.rc_ring_dropped(self._h)

    def provider(self, strict: bool = True, bf16=False):
        """A SiteRuntime block provider. ``strict`` returns None when the
        ring can't fill a block (skip the step); non-strict zero-fills —
        live capture keeps real-time cadence through dropouts. ``bf16``
        delivers blocks in the TPU compute dtype (see :meth:`pop_bf16`);
        pass ``"auto"`` to enable it only for wire formats where the
        conversion is lossless (8-bit cu8/cs8 — bf16 has an 8-bit
        mantissa, so ≥12-bit cs16/cf32 sources would silently lose
        precision)."""
        if bf16 == "auto":
            bf16 = self.fmt in _BF16_LOSSLESS
        elif bf16 and self.fmt not in _BF16_LOSSLESS:
            log.warning(
                "bf16 ingest on %r wire format truncates to bf16's "
                "8-bit mantissa; use bf16='auto' to gate on format",
                self.fmt)
        if bf16:
            def pull16(n: int):
                b = self.pop_bf16(n)
                if b is None and not strict:
                    return np.zeros((n, 2), np.uint16)
                return b
            return pull16

        def pull(n: int):
            b = self.pop(n)
            if b is None and not strict:
                return np.zeros((n, 2), np.float32)
            return b
        return pull

    def close(self) -> None:
        if self._h:
            self._lib.rc_ring_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class UdpFeed:
    """Legacy UDP IQ transport (receiver.py:91-92: 1.25 MB buffers),
    pumping datagrams into a ring on a native-blocking thread."""

    def __init__(self, ring: IngestRing, port: int,
                 bind_addr: str = "0.0.0.0", rcvbuf: int = 1250000,
                 max_datagram: int = 147200):
        self._lib = _load()
        self._ring = ring
        self._h = self._lib.rc_udp_open(bind_addr.encode(), port, rcvbuf)
        if not self._h:
            raise OSError(f"cannot bind udp {bind_addr}:{port}")
        self._thread = threading.Thread(
            target=self._lib.rc_udp_pump,
            args=(self._h, ring._h, max_datagram),
            daemon=True, name=f"udp-ingest-{port}")
        self._thread.start()

    def stop(self) -> None:
        self._lib.rc_udp_stop(self._h)
        self._thread.join(timeout=2.0)
        self._lib.rc_udp_close(self._h)
        self._h = None
