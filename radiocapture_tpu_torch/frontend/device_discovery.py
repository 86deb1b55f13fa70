"""SDR device discovery + presence publication.

Replaces the reference's ``rc_frontend/device_discovery.py`` (:9-82):
there, librtlsdr is loaded via ctypes, every attached RTL-SDR dongle's
(index, name, serial) tuple is enumerated, and the table is published to
Redis under ``device_table:<host-hash>`` every 10 s so a (planned)
cluster allocator can map dongles to hosts (README.md:5 autodiscovery).

Here the same enumeration runs when librtlsdr is present, and file/
synthetic sources declared in the deployment config are reported the
same way — the TPU deployment's "devices" are usually IQ feeds, not
local USB dongles.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import socket
import threading
import time


def enumerate_rtlsdr() -> list[dict]:
    """librtlsdr enumeration (device_discovery.py:9-47); [] when the
    library or dongles are absent."""
    libname = ctypes.util.find_library("rtlsdr")
    if not libname:
        return []
    try:
        lib = ctypes.CDLL(libname)
    except OSError:
        return []
    lib.rtlsdr_get_device_count.restype = ctypes.c_uint32
    lib.rtlsdr_get_device_name.restype = ctypes.c_char_p
    lib.rtlsdr_get_device_name.argtypes = [ctypes.c_uint32]
    n = lib.rtlsdr_get_device_count()
    devices = []
    for i in range(n):
        name = lib.rtlsdr_get_device_name(i)
        manufact = ctypes.create_string_buffer(256)
        product = ctypes.create_string_buffer(256)
        serial = ctypes.create_string_buffer(256)
        try:
            lib.rtlsdr_get_device_usb_strings(i, manufact, product, serial)
        except Exception:
            pass
        devices.append({
            "index": i, "type": "rtlsdr",
            "name": (name or b"").decode(errors="replace"),
            "manufacturer": manufact.value.decode(errors="replace"),
            "product": product.value.decode(errors="replace"),
            "serial": serial.value.decode(errors="replace"),
        })
    return devices


def enumerate_configured(sources: dict | None) -> list[dict]:
    """Report config-declared sources (file/synthetic/usrp/bladerf) the
    same way hardware is."""
    out = []
    for idx, src in (sources or {}).items():
        get = src.get if isinstance(src, dict) else \
            (lambda k, d=None: getattr(src, k, d))
        out.append({"index": idx, "type": get("type", "file"),
                    "name": str(get("args", "")),
                    "center_freq": get("center_freq", 0.0),
                    "samp_rate": get("samp_rate", 0.0)})
    return out


class DeviceDiscovery:
    """Publish the device table to a presence store every ``period``
    seconds under ``device_table:<host-hash>``
    (device_discovery.py:49-82)."""

    PERIOD_S = 10.0

    def __init__(self, store, sources: dict | None = None,
                 host: str | None = None):
        self.store = store
        self.sources = sources
        self.host = host or socket.gethostname()
        self.host_hash = hashlib.md5(self.host.encode()).hexdigest()[:12]
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def table(self) -> dict:
        devices = enumerate_rtlsdr() + enumerate_configured(self.sources)
        return {"host": self.host, "time": time.time(),
                "devices": devices}

    def publish_once(self) -> dict:
        t = self.table()
        self.store.publish("device_table", self.host_hash, t)
        return t

    def start(self) -> "DeviceDiscovery":
        def loop():
            while not self._stop.is_set():
                self.publish_once()
                self._stop.wait(self.PERIOD_S)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

def main(argv=None):
    """Service entry (deploy/radiocapture-tpu-device-discovery.service;
    reference systemd/radiocapture-device-discovery.service)."""
    import argparse
    import logging
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-c", "--config", default=None,
                    help="deployment config; its sources are reported "
                         "alongside enumerated hardware")
    ap.add_argument("--redis-host", default=None)
    ap.add_argument("--redis-port", type=int, default=6379)
    ap.add_argument("--once", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    sources = None
    if args.config:
        from radiocapture_tpu_torch.rxconfig import load_config
        sources = load_config(args.config).sources
    from radiocapture_tpu_torch.control.presence import (PresenceStore,
                                                   RedisPresenceStore)
    store = (RedisPresenceStore([{"host": args.redis_host,
                                  "port": args.redis_port}])
             if args.redis_host else PresenceStore())
    dd = DeviceDiscovery(store, sources)
    t = dd.publish_once()
    logging.info("device table: %d devices", len(t["devices"]))
    if args.once:
        return
    dd.start()
    try:
        while True:
            time.sleep(60)
    except KeyboardInterrupt:
        dd.stop()


if __name__ == "__main__":
    main()
