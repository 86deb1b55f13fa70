"""Presence / discovery: who is alive, where, covering what spectrum.

Reference semantics preserved (SURVEY.md §2 L2, §5.3):
- publishers re-announce a JSON record every ``publish_period`` (1 s)
  under a kind-scoped set — channelizers under ``channelizers``
  (rc_frontend/redis_channel_publisher.py:59-93), demods under
  ``demod:<type>`` (redis_demod_publisher.py:42-81);
- managers reap records silent > ``ttl`` (5 s) and fire
  ``notify_new``/``notify_expire`` callbacks (redis_demod_manager.py:
  56-110, redis_channelizer_manager.py:106-110);
- frequency→channelizer routing picks the instance whose source covers
  the frequency with minimum |freq − center|, random tie-break
  (redis_channelizer_manager.py:52-76).

The default store is in-process; a Redis store drops in for multi-host
control planes (same record schema on the wire).
"""

from __future__ import annotations

import json
import random
import threading
import time
from typing import Callable


class PresenceStore:
    """In-process timestamped record store: {kind: {uuid: (ts, record)}}."""

    def __init__(self):
        self._data: dict[str, dict[str, tuple[float, dict]]] = {}
        self._lock = threading.RLock()

    def publish(self, kind: str, uid: str, record: dict) -> None:
        with self._lock:
            self._data.setdefault(kind, {})[uid] = (time.monotonic(), record)

    def remove(self, kind: str, uid: str) -> None:
        with self._lock:
            self._data.get(kind, {}).pop(uid, None)

    def live(self, kind: str, ttl: float = 5.0) -> dict[str, dict]:
        now = time.monotonic()
        with self._lock:
            entries = dict(self._data.get(kind, {}))
        return {u: rec for u, (ts, rec) in entries.items()
                if now - ts <= ttl}

    def kinds(self, prefix: str = "") -> list[str]:
        with self._lock:
            return [k for k in self._data if k.startswith(prefix)]


class RedisPresenceStore:
    """Same contract over Redis keys with TTL (multi-host): instance
    sets + per-uuid JSON blobs with server-side expiry, matching the
    reference's record shape (redis_demod_publisher.py:74-78,
    redis_demod_manager.py:41-50). Built on the in-repo RESP client
    (control.resp) — no package dependency; connection failures degrade
    to empty results (presence is best-effort liveness data)."""

    def __init__(self, servers: list[dict]):
        from radiocapture_tpu_torch.control.resp import RespClient
        self._redis = [RespClient(host=s.get("host", "localhost"),
                                  port=s.get("port", 6379))
                       for s in (servers or [{}])]

    def publish(self, kind: str, uid: str, record: dict) -> None:
        data = json.dumps({"t": time.time(), "record": record})
        for r in self._redis:
            try:
                r.sadd(kind, uid)
                r.set(f"{kind}:{uid}", data, ex=10)
            except Exception:
                pass

    def remove(self, kind: str, uid: str) -> None:
        for r in self._redis:
            try:
                r.srem(kind, uid)
                r.delete(f"{kind}:{uid}")
            except Exception:
                pass

    def live(self, kind: str, ttl: float = 5.0) -> dict[str, dict]:
        out: dict[str, dict] = {}
        now = time.time()
        for r in self._redis:
            try:
                for uid in r.smembers(kind):
                    uid = uid.decode()
                    raw = r.get(f"{kind}:{uid}")
                    if raw is None:
                        r.srem(kind, uid)   # reap (redis_demod_manager)
                        continue
                    blob = json.loads(raw)
                    if now - blob["t"] <= ttl:
                        out[uid] = blob["record"]
            except Exception:
                pass
        return out

    def kinds(self, prefix: str = "") -> list[str]:
        # cursor-based SCAN, not KEYS: the latter is a blocking
        # O(keyspace) command that can stall a shared production Redis
        seen = set()
        for r in self._redis:
            try:
                for k in r.scan_iter(prefix + "*"):
                    k = k.decode()
                    if ":" not in k[len(prefix):]:
                        seen.add(k)
            except Exception:
                pass
        return sorted(seen)


class PresencePublisher:
    """Re-announces one record every ``period`` until stopped
    (the reference's 1 s publisher threads)."""

    def __init__(self, store, kind: str, uid: str,
                 record_fn: Callable[[], dict], period: float = 1.0):
        self.store = store
        self.kind = kind
        self.uid = uid
        self.record_fn = record_fn
        self.period = period
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"presence-{kind}-{uid[:8]}")

    def start(self) -> "PresencePublisher":
        self.store.publish(self.kind, self.uid, self.record_fn())
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            self.store.publish(self.kind, self.uid, self.record_fn())

    def stop(self) -> None:
        self._stop.set()
        self.store.remove(self.kind, self.uid)


class DemodManager:
    """Tracks live demod instances across kinds ``demod:<type>``;
    fires new/expire callbacks (redis_demod_manager.py:56-110)."""

    def __init__(self, store, ttl: float = 5.0,
                 notify_new: Callable[[str, str, dict], None] | None = None,
                 notify_expire: Callable[[str, str], None] | None = None):
        self.store = store
        self.ttl = ttl
        self.notify_new = notify_new or (lambda t, u, r: None)
        self.notify_expire = notify_expire or (lambda t, u: None)
        self._known: dict[str, str] = {}   # uuid -> type

    def poll(self) -> dict[str, dict]:
        """One reap/notify sweep; returns {uuid: record} of live demods."""
        live: dict[str, dict] = {}
        seen: dict[str, str] = {}
        for kind in self.store.kinds("demod:"):
            dtype = kind.split(":", 1)[1]
            for uid, rec in self.store.live(kind, self.ttl).items():
                live[uid] = rec
                seen[uid] = dtype
                if uid not in self._known:
                    self.notify_new(dtype, uid, rec)
        for uid, dtype in list(self._known.items()):
            if uid not in seen:
                self.notify_expire(dtype, uid)
        self._known = seen
        return live


class ChannelizerManager:
    """Frequency→channelizer routing over live channelizer records.

    A record is ``{"host":…, "port":…, "sources": [{"center_freq":…,
    "samp_rate":…}], …}`` (redis_channel_publisher.py:74-88).
    """

    def __init__(self, store, ttl: float = 5.0,
                 rng: random.Random | None = None):
        self.store = store
        self.ttl = ttl
        self.rng = rng or random.Random()

    def live(self) -> dict[str, dict]:
        return self.store.live("channelizers", self.ttl)

    def get_channelizer_for_frequency(self, freq: float) -> tuple[str,
                                                                  dict] | None:
        """Min |freq−center| among sources that cover freq; random
        tie-break (redis_channelizer_manager.py:52-76)."""
        best: list[tuple[str, dict]] = []
        best_off = None
        for uid, rec in self.live().items():
            for src in rec.get("sources", []):
                half = src["samp_rate"] / 2.0
                off = abs(freq - src["center_freq"])
                if off > half:
                    continue
                if best_off is None or off < best_off:
                    best, best_off = [(uid, rec)], off
                elif off == best_off:
                    best.append((uid, rec))
        if not best:
            return None
        return self.rng.choice(best)
