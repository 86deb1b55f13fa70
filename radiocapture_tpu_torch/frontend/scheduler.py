"""Channel slot scheduler: dynamic channel lifecycle on static shapes.

The reference's frontend serves ``create/release/hb/offset`` RPCs by
spawning or retuning one GNU Radio flowgraph per channel
(rc_frontend/receiver.py:503-700, 282-341) with a 10 s idle-reuse pool
(receiver.py:51,307-341,635-649) and 5 s client-heartbeat reaping
(receiver.py:651-680). The TPU pipeline instead processes a fixed
``num_slots`` batch every block (frontend/pipeline.py), so channel
create/release becomes *slot allocation*: an allocated slot's offset
goes live in the next block's ``offsets_norm`` array; a released slot
lingers idle (hysteresis, same economics as the reference's reuse pool)
and is reclaimed lazily. Nothing here touches the device or triggers
recompilation — slot offsets are runtime data.

Client semantics match frontend_connector.py: clients heartbeat every
0.25 s, are reaped after ``client_ttl`` (5 s) silence, and their slots
are released (receiver.py:654). AFC offset reports retune the *source*
center frequency with the reference's sanity clamp
(receiver.py:436-475).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np


FREE, ACTIVE, IDLE = 0, 1, 2


@dataclass
class Slot:
    state: int = FREE
    freq: float = 0.0
    rate: float = 0.0
    client: str | None = None
    close_time: float = 0.0
    block_id: int = -1            # stable handle returned to clients


@dataclass
class SourceSlots:
    """Slot pool for one wideband source."""
    center_freq: float
    samp_rate: float
    num_slots: int
    afc_offset: float = 0.0
    slots: list = field(default_factory=list)

    def __post_init__(self):
        if not self.slots:
            self.slots = [Slot() for _ in range(self.num_slots)]

    def covers(self, freq: float) -> bool:
        return abs(freq - self.center_freq) <= self.samp_rate / 2.0


class ChannelScheduler:
    """Allocates channel slots across sources; produces per-block offset
    arrays and activity masks for the batched pipelines."""

    IDLE_REUSE_S = 10.0       # receiver.py:51
    CLIENT_TTL_S = 5.0        # receiver.py:654
    MAX_AFC_HZ = 1200.0       # receiver.py:464-466 sanity clamp

    def __init__(self, sources: dict[int, tuple[float, float]],
                 num_slots: int = 64, now_fn=None):
        """sources: {index: (center_freq_hz, samp_rate)}.

        ``now_fn``: clock for the idle-reuse window and client TTLs
        (default wall monotonic). Stream-clocked runtimes pass their
        block clock so slot hysteresis follows *stream* time — offline
        decode faster or slower than real time keeps the reference's
        10 s/5 s economics instead of the host's wall speed."""
        self._lock = threading.RLock()
        self.now = now_fn or time.monotonic
        self.sources = {
            idx: SourceSlots(center_freq=cf, samp_rate=sr,
                             num_slots=num_slots)
            for idx, (cf, sr) in sources.items()}
        self._clients: dict[str, float] = {}
        self._next_block_id = 0

    # ---- the reference's RPC verbs (frontend_connector.py:127-192) ----
    def connect(self, client: str) -> None:
        with self._lock:
            self._clients[client] = self.now()

    def heartbeat(self, client: str) -> bool:
        with self._lock:
            if client not in self._clients:
                return False
            self._clients[client] = self.now()
            return True

    def create_channel(self, client: str, rate: float, freq: float
                       ) -> tuple[int, int, int] | None:
        """Allocate a slot for ``freq``; returns (source_idx, slot_idx,
        block_id) or None if no source covers the frequency / pool full.

        Reuse order mirrors the reference: an IDLE slot (within the
        reuse window) is retuned in place before a FREE slot is taken
        (receiver.py:307-341).
        """
        ex = self.create_channel_ex(client, rate, freq)
        return None if ex is None else ex[:3]

    def create_channel_ex(self, client: str, rate: float, freq: float
                          ) -> tuple[int, int, int, bool] | None:
        """:meth:`create_channel` plus a ``warm`` flag: True when the
        allocation retuned an idle slot in place (the reference's
        sub-second channel-reuse economics, receiver.py:307-319), False
        when it claimed a cold FREE slot."""
        with self._lock:
            self._clients.setdefault(client, self.now())
            src_idx = self._route(freq)
            if src_idx is None:
                return None
            pool = self.sources[src_idx]
            pick, warm = None, False
            for i, s in enumerate(pool.slots):
                if s.state == IDLE:
                    pick, warm = i, True
                    break
            if pick is None:
                for i, s in enumerate(pool.slots):
                    if s.state == FREE:
                        pick = i
                        break
            if pick is None:
                return None
            s = pool.slots[pick]
            s.state, s.freq, s.rate, s.client = ACTIVE, freq, rate, client
            s.block_id = self._next_block_id
            self._next_block_id += 1
            return src_idx, pick, s.block_id, warm

    def release_channel(self, client: str, block_id: int) -> bool:
        with self._lock:
            for pool in self.sources.values():
                for s in pool.slots:
                    if s.block_id == block_id and s.client == client:
                        s.state = IDLE
                        s.client = None
                        s.close_time = self.now()
                        return True
            return False

    def retune_channel(self, client: str, block_id: int, freq: float
                       ) -> bool:
        with self._lock:
            for pool in self.sources.values():
                for s in pool.slots:
                    if s.block_id == block_id and s.client == client:
                        if not pool.covers(freq):
                            return False
                        s.freq = freq
                        return True
            return False

    def report_offset(self, source_idx: int, offset_hz: float) -> float:
        """AFC: accumulate a measured DC offset into the source center,
        clamped like the reference's sign-flip sanity check
        (receiver.py:436-475). Returns the new effective afc offset."""
        with self._lock:
            pool = self.sources[source_idx]
            new = pool.afc_offset + offset_hz
            pool.afc_offset = float(np.clip(new, -self.MAX_AFC_HZ,
                                            self.MAX_AFC_HZ))
            return pool.afc_offset

    def quit(self, client: str) -> None:
        with self._lock:
            self._clients.pop(client, None)
            self._release_all_for(client)

    # ---- periodic maintenance (receiver.py:635-680) ----
    def reap(self, now: float | None = None) -> None:
        now = self.now() if now is None else now
        with self._lock:
            for client, last in list(self._clients.items()):
                if now - last > self.CLIENT_TTL_S:
                    del self._clients[client]
                    self._release_all_for(client)
            for pool in self.sources.values():
                for s in pool.slots:
                    if s.state == IDLE and \
                            now - s.close_time > self.IDLE_REUSE_S:
                        s.state = FREE
                        s.block_id = -1

    def _release_all_for(self, client: str) -> None:
        for pool in self.sources.values():
            for s in pool.slots:
                if s.client == client:
                    s.state = IDLE
                    s.client = None
                    s.close_time = self.now()

    def _route(self, freq: float) -> int | None:
        """Source with minimum |freq − center| that covers freq
        (redis_channelizer_manager.py:52-76 routing, intra-host)."""
        best, best_off = None, None
        for idx, pool in self.sources.items():
            if not pool.covers(freq):
                continue
            off = abs(freq - pool.center_freq)
            if best_off is None or off < best_off:
                best, best_off = idx, off
        return best

    # ---- pipeline feed ----
    def offsets_norm(self, source_idx: int) -> np.ndarray:
        """[num_slots] float32 cycles/sample for the pipeline step; idle
        and free slots keep their last frequency (don't-care, masked)."""
        with self._lock:
            pool = self.sources[source_idx]
            center = pool.center_freq + pool.afc_offset
            return np.array(
                [(s.freq - center) / pool.samp_rate for s in pool.slots],
                np.float32)

    def active_mask(self, source_idx: int) -> np.ndarray:
        with self._lock:
            return np.array([s.state == ACTIVE
                             for s in self.sources[source_idx].slots],
                            bool)

    def slot_of(self, block_id: int) -> tuple[int, int] | None:
        with self._lock:
            for idx, pool in self.sources.items():
                for i, s in enumerate(pool.slots):
                    if s.block_id == block_id:
                        return idx, i
            return None

    def stats(self) -> dict:
        with self._lock:
            active = sum(1 for p in self.sources.values()
                         for s in p.slots if s.state == ACTIVE)
            idle = sum(1 for p in self.sources.values()
                       for s in p.slots if s.state == IDLE)
            return {"clients": len(self._clients), "active": active,
                    "idle": idle,
                    "capacity": sum(p.num_slots
                                    for p in self.sources.values())}
